#!/usr/bin/env python3
"""Time the mel-log-DCT kernel of one checkout of this repository on a CUDA
card by chip_smoke.py's phase-3 method, so that two versions of the kernel
can be compared on one card.

    mkdir -p build/old && git archive <commit> | tar -x -C build/old
    python3 var_tpu_torch/tools/kernel_times.py build/old [--slice]
    python3 var_tpu_torch/tools/kernel_times.py . [--slice]

CHECKOUT must lie inside this checkout (build/ is ignored by git). Its
var_tpu_torch package is imported and its kernel built into its own build/
directory. This checkout's chip_smoke.py does the rest: `kernel_times`
(three shapes, both input layouts, cold and warm) and, with --slice, phases
4-6 (the pretext slice, pallas against gemm, the profiled epoch) on that
package. A wrapper that refuses the gemm STFT's view, as the first version
of the kernel did, is timed as its path ran it: a contiguous copy, then the
kernel. Run one process per checkout, in turns (A, B, B, A), in one call on
one card. The last line is one JSON object with the times.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import types
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def main(argv=None):
    args = sys.argv[1:] if argv is None else argv
    if not args or args[0].startswith("-"):
        sys.exit(__doc__)
    root = Path(args[0]).resolve()
    if not root.is_relative_to(REPO):
        sys.exit(f"{root} lies outside this checkout ({REPO})")
    # chip_smoke.py of this checkout, by path: CHECKOUT has its own
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False")
    sys.path.insert(0, str(root))
    from var_tpu_torch.ops import audio
    from var_tpu_torch.ops import mel_log_dct as mld

    if not Path(mld.__file__).resolve().is_relative_to(root):
        cs.fail(f"imported {mld.__file__}, not the package of {root}")
    mld.build(force=True)
    params, layouts = cs.spectrograms(torch, np, audio, "GoogleCommand", 2, 10)
    wrap, how = mld, "kernel"
    try:
        mld.mel_log_dct(layouts["stft view"], params)
    except ValueError:  # a wrapper that takes contiguous input only
        how = "copy + kernel"
        wrap = types.SimpleNamespace(
            mel_log_dct=lambda x, params: mld.mel_log_dct(x.contiguous(),
                                                          params),
            mel_log_dct_reference=mld.mel_log_dct_reference)
    print(f"kernel_times {root}: the view is timed as {how}", flush=True)
    rows = cs.kernel_times(torch, np, wrap, audio)
    if "--slice" in args:
        trainer, _ = cs.run_slice(torch)
        cs.breakdown(torch, *cs.backend_agreement(torch, trainer.config))
    print(json.dumps({"checkout": str(root.relative_to(REPO)),
                      "view_timed_as": how, "card": cs.card_line(),
                      "kernel_times": rows}))


if __name__ == "__main__":
    main()
