"""``sample(mesh=)`` and ``optimize(mesh=)`` with the shards on distinct
GPUs of one host.

    python3 tools/mesh_cards.py

Needs two CUDA devices or more.  Builds the kernels, then runs
``chip_smoke.phase_main_mesh``, ``phase_main_mesh_mcz`` (DE-MCz: a
history replica a card, each iteration's rows copied between the cards)
and ``phase_main_data_mesh`` (the data pieces on the cards in row-major
order, repeated to fill the mesh: on four cards data column j of the
2 × 2 Gaussian mesh is card 2i + j of row i, and LBA's piece j of
``data_mesh(2, 4)`` is card j) over the visible cards twice: on cards
``0, 1, ..`` (the mesh's first card the current one) and on ``1, .., 0``
(K2 and the gather on a card that is not the current one, and shards on
cards other than the current one).  Each cell's unsharded run is on
``cuda:0``; every sharded run must equal it bit for bit, with K1 once per
planned window and shard and K2 once per open gate (K4 once per iteration
and shard for abc_kde).  Prints the per-cell lines of
``chip_smoke._mesh_runs`` (µs per iteration of 1, 2, .. shards on as many
cards), one JSON line of the metrics per card order, then every card's
name and power limit.
"""

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    import torch
    import chip_smoke as cs
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        sys.exit(f"mesh_cards: needs two CUDA devices or more, found {n}")
    cs.phase_build()
    cards = [torch.device("cuda", i) for i in range(n)]
    for order in (cards, cards[1:] + cards[:1]):
        tag = "cards-" + "".join(str(d.index) for d in order)
        _, metrics = cs.phase_main_mesh(cards[0], order, tag)
        _, mcz = cs.phase_main_mesh_mcz(cards[0], order, tag + "-mcz")
        data = cs.phase_main_data_mesh(cards[0], order, tag + "-data")
        print(json.dumps({"cards": [str(d) for d in order], **metrics,
                          **mcz, **data}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
