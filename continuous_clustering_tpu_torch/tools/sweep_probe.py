"""Run the CC sweep's probe variants and hold each against its plain twin
(the counterpart of ``scripts/pallas_bisect.py``).

    python -m continuous_clustering_tpu_torch.tools.sweep_probe [--device cpu] [--seed N]

On the card (the default) every variant's kernel runs at ``upper`` = 1, 7
and 21 (= H + 1) on inputs made from ``--seed`` and must equal its twin
exactly; ``--device cpu`` runs the twins only.  Prints one line per variant
in the script's order, ``<name>: OK`` or ``<name>: FAIL <reason>``, and exits
non-zero on any FAIL.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Tuple

import numpy as np
import torch

from ..ops.sweep_probe import B, H, R, VARIANTS, sweep_probe, sweep_probe_reference

UPPERS = (1, 7, H + 1)


def probe_inputs(seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(bits (H+1, 2, R, B), L (R, H+B)) i32: dense random edge words and
    labels in [-4, 8), small enough for every variant's tests to take both
    values."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(-2**31, 2**31, (H + 1, 2, R, B), dtype=np.int64).astype(np.int32)
    L = rng.integers(-4, 8, (R, H + B)).astype(np.int32)
    return bits, L


def run(device="cuda", seed: int = 0, uppers=UPPERS) -> List[Tuple[str, str, int]]:
    """(name, "OK" or "FAIL <reason>", max |kernel - twin| over the uppers
    that ran) per variant, in the script's order."""
    dev = torch.device(device)
    bits_np, L_np = probe_inputs(seed)
    bits, L = torch.from_numpy(bits_np).to(dev), torch.from_numpy(L_np).to(dev)
    results = []
    for name in VARIANTS:
        reasons, err = [], 0
        for upper in uppers:
            u = torch.tensor(upper, dtype=torch.int32, device=dev)
            try:
                got = sweep_probe(name, bits, u, L)
            except (RuntimeError, ValueError) as e:
                reasons.append(f"upper={upper}: {e}")
                continue
            want = sweep_probe_reference(name, bits, u, L)
            err = max(err, int((got.long() - want.long()).abs().max()))
            if not torch.equal(got, want):
                n = int((got != want).sum())
                reasons.append(f"upper={upper}: {n} of {want.numel()} cells differ")
        results.append((name, "FAIL " + "; ".join(reasons) if reasons else "OK", err))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (kernels vs twins) or cpu (twins)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    results = run(args.device, args.seed)
    for name, status, _ in results:
        print(f"{name}: {status}", flush=True)
    return 0 if all(s == "OK" for _, s, _ in results) else 1


if __name__ == "__main__":
    sys.exit(main())
