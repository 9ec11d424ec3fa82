#!/usr/bin/env python3
"""Time one tree's f32 flash kernels and f32 training step on the card,
with chip_smoke.py's own phases: the main-shape f32 flash rows
(``flash_check``: forward, dq and dk/dv against their plain versions,
beside SDPA in f32 and both bounds) and the f32 train arm
(``train_phase`` on ``TRAIN_F32``, 2 Adam steps, then one profiled
step), each line as chip_smoke.py prints it.  With ``--wide``, the same
above hd 128 instead: the f32 rows at ``WIDE_FULL`` (b 2, 16 heads over
4 kv heads, s 4096, hd 256, causal) and at the small wide-head shapes
(``WIDE_FLASH``: hd 192, 256, 512), and the f32 hd 256 arm
(``TRAIN_WIDE`` in f32).

    python3 hack/f32_turns.py [--tree DIR] [--seed 0] [--wide]

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
    ap.add_argument("--wide", action="store_true",
                    help="the hd 256 rows and arm instead of the hd 128 ones")
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
    # which of the f32 kernels (forward, dq, dk/dv) the tree's 3xTF32
    # source defines: the profiled step requires those it has
    src = os.path.join(tree, "vtpu_torch", "csrc",
                       "flash_attention_tf32x3.cu")
    code = open(src).read() if os.path.exists(src) else ""
    need = cs.F32_WIDE_KERNELS if args.wide else cs.F32_KERNELS
    have = tuple(name for name in need if name + "<" in code)
    cs.emit(phase="turn", tree=tree, package=vtpu_torch.__file__,
            wide=args.wide, tf32x3=list(have), card=card)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    if args.wide:
        cs.flash_check(gen, torch.float32, cs.WIDE_FULL, time_it=True,
                       card=card, shape_tag="wide_full",
                       earlier=cs.f32_earlier("wide_full"))
        for geom in cs.WIDE_FLASH:
            cs.flash_check(gen, torch.float32, geom, time_it=True,
                           card=card, shape_tag="wide_heads")
        cs.train_phase(card, args.seed, cs.TRAIN_WIDE,
                       cs.TRAIN_WIDE_STEPS, arm="f32_wide",
                       dtype=torch.float32, profile="train_step_f32_wide",
                       require=have)
    else:
        cs.flash_check(gen, torch.float32, cs.FLASH, time_it=True,
                       card=card, earlier=cs.f32_earlier("main"))
        cs.train_phase(card, args.seed, cs.TRAIN_F32, cs.TRAIN_F32_STEPS,
                       arm="f32", dtype=torch.float32,
                       profile="train_step_f32", require=have)
    return 0


if __name__ == "__main__":
    sys.exit(main())
