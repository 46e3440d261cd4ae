#!/usr/bin/env python3
"""Time the gcd_score and pq_assign kernels of any checkout on one GPU.

Run from the repository root:

    python3 kernel_bench.py [--src DIR]
    python3 kernel_bench.py --split

Times each kernel as ``chip_smoke.py`` does (device time per launch from a
CUDA graph of back-to-back launches) beside its plain version and its bound
(bytes over 3.35 TB/s or float32 operations over 67 TFLOP/s), on seeded
operands at the smoke's shapes: ``gcd_score`` at the serving width, the
training width and ``chip_smoke.GCD_RAGGED``, with the one ``torch.matmul``
that computes the same field; ``pq_assign`` at every entry of
``chip_smoke.ASSIGN_SHAPES``. ``chip_smoke.py`` holds both kernels to their
plain versions at these shapes; this script only times them, so that two
checkouts can be timed at the same shapes in one call.

``--src`` imports ``repro_torch`` from another checkout's ``src/`` (a
``git archive`` of an earlier commit, say), whose kernels its own
``_build`` compiles into that checkout. For parent against change on one
card, run parent, change, change, parent in one call.

``--split`` times where ``gcd_score``'s time goes instead, at n = 256 and
512: the kernel as built, a copy of its source with the FMAs taken out
(the copies alone) and one with every copy after the first ring stage
taken out (the contraction alone, on stale data), built by ``nvcc`` with
the port's flags into ``build/kernel_bench/``.

One JSON line per case, then the card's ``nvidia-smi`` name and power
limit. Exits 1 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as smoke

#: the serving width, the training width (paper_twotower's 512) and the
#: ragged widths the smoke checks
GCD_NS = tuple(sorted({smoke.DIM, 512, *smoke.GCD_RAGGED}))
#: --split: text edits of gcd_score.cu that leave one half of the work
GCD_PARTS = {
    "copies_only": [("    if (active) {", "    if (active && n < 0) {")],
    "contraction_only": [("    if (s < stages) stage(s);",
                          "    if (s == 0) stage(s);"),
                         ("    if (s + S - 1 < stages) stage(s + S - 1);",
                          "")],
}


def _gcd_operands(g, n: int):
    import torch

    G = torch.randn((n, n), generator=g, device=g.device)
    R = torch.linalg.qr(torch.randn((n, n), generator=g, device=g.device))[0]
    return G, R.contiguous()


def time_gcd(g, n: int) -> None:
    import torch

    from repro_torch.kernels import ops, ref

    G, R = _gcd_operands(g, n)
    lhs = torch.cat([G, -R], dim=0).T.contiguous()
    rhs = torch.cat([R, G], dim=0).contiguous()
    flops, nbytes = 2 * n ** 3 + n * n, 3 * n * n * 4
    print(json.dumps(dict(
        kernel="gcd_score", n=n,
        ms=smoke.graph_ms(lambda: ops.gcd_score(G, R), launches=100),
        plain_ms=smoke.graph_ms(lambda: ref.gcd_score_ref(G, R),
                                launches=100),
        library_ms=smoke.graph_ms(lambda: torch.matmul(lhs, rhs),
                                  launches=100),
        bytes=nbytes, flops=flops, **smoke._bound(nbytes, flops))),
        flush=True)


def time_assign(g, name: str) -> None:
    from repro_torch.kernels import ops, ref

    m, D, K, sub = smoke.ASSIGN_SHAPES[name]
    X, C = smoke.assign_operands(g, m, D, K, sub)
    nbytes = m * D * sub * 4 + D * K * sub * 4 + m * D * 4
    flops = 2 * m * D * sub * K
    print(json.dumps(dict(
        kernel="pq_assign", case=name, m=m, D=D, K=K, sub=sub,
        ms=smoke.graph_ms(lambda: ops.pq_assign(X, C),
                          launches=5 if flops > 2e10 else 20),
        plain_ms=smoke.graph_ms(lambda: ref.pq_assign_ref(X, C), launches=2),
        bytes=nbytes, flops=flops, **smoke._bound(nbytes, flops))),
        flush=True)


def gcd_split(g) -> None:
    """Time gcd_score beside its two halves (see the module docstring)."""
    import ctypes

    import torch

    from repro_torch.kernels import _build, ops

    out_dir = _build.BUILD_DIR.parent / "kernel_bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "gcd_score.cu").read_text()
    nvcc, libs = _build.nvcc_path(), {}
    for part, edits in GCD_PARTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"--split: {old!r} not in gcd_score.cu")
            text = text.replace(old, new)
        cu = out_dir / f"gcd_{part}.cu"
        cu.write_text(text)
        lib = out_dir / f"libgcd_{part}.so"
        subprocess.run([nvcc, *_build.FLAGS, "-I", str(_build.CSRC),
                        "-shared", "-o", str(lib), str(cu)], check=True,
                       capture_output=True)
        libs[part] = ctypes.CDLL(str(lib)).repro_gcd_score
        libs[part].argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
    for n in (256, 512):
        G, R = _gcd_operands(g, n)
        A = torch.empty_like(G)
        tile = ops.gcd_score_tile(n)
        row = dict(kernel="gcd_score", n=n, ms=smoke.graph_ms(
            lambda: ops.gcd_score(G, R), launches=100))
        for part, fn in libs.items():
            def call(fn=fn, part=part):
                smoke.check(fn(G.data_ptr(), R.data_ptr(), A.data_ptr(), n,
                               tile, torch.cuda.current_stream().cuda_stream)
                            == 0, f"gcd_score {part} launch")
            row[f"{part}_ms"] = smoke.graph_ms(call, launches=100)
        print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=None,
                    help="import repro_torch from this src/ directory")
    ap.add_argument("--split", action="store_true",
                    help="time gcd_score's copies and contraction apart")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device is available", file=sys.stderr)
        return 1
    if args.src is not None:
        sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.kernels import _build, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    print(json.dumps(dict(repro_torch=ops.__file__,
                          build=_build.build_info)), flush=True)
    g = torch.Generator(device="cuda")
    g.manual_seed(smoke.SEED + 5)
    if args.split:
        gcd_split(g)
    else:
        for n in GCD_NS:
            time_gcd(g, n)
        for name in smoke.ASSIGN_SHAPES:
            time_assign(g, name)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
