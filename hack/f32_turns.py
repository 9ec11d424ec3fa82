#!/usr/bin/env python3
"""Time one tree's f32 flash backward and f32 training step on the card,
with chip_smoke.py's own phases: the main-shape f32 flash rows
(``flash_check``: forward, dq and dk/dv against their plain versions,
beside SDPA in f32 and both bounds) and the f32 train arm
(``train_phase`` on ``TRAIN_F32``, 2 Adam steps, then one profiled
step), each line as chip_smoke.py prints it.

    python3 hack/f32_turns.py [--tree DIR] [--seed 0]

DIR (default: this checkout) goes first on ``sys.path``, so its
``vtpu_torch`` (kernels built from its ``csrc`` into its own ``_build``)
runs under this checkout's chip_smoke.py.  To compare two trees on one
card, run it once per tree in one call, in turns (parent, change,
change, parent).  Needs a card; prints nothing of use without one.
"""

import argparse
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("f32_turns: CUDA is not available", file=sys.stderr)
        return 2
    # this checkout's chip_smoke.py, whichever tree's package runs
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from vtpu_torch.device import reference_numerics

    import vtpu_torch

    reference_numerics()
    card = cs.card_line()
    tf32x3 = os.path.exists(os.path.join(
        tree, "vtpu_torch", "csrc", "flash_attention_tf32x3.cu"))
    cs.emit(phase="turn", tree=tree, package=vtpu_torch.__file__,
            tf32x3=tf32x3, card=card)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    cs.flash_check(gen, torch.float32, cs.FLASH, time_it=True, card=card)
    cs.train_phase(card, args.seed, cs.TRAIN_F32, cs.TRAIN_F32_STEPS,
                   arm="f32", dtype=torch.float32, profile="train_step_f32",
                   require=cs.F32_BWD_KERNELS if tf32x3 else ())
    return 0


if __name__ == "__main__":
    sys.exit(main())
