"""How far the LSTM kernels' scan forms (``ops.lstm.lstm_scan_forward_cuda``,
``lstm_scan_backward_cuda``: the d-vector in bfloat16) and their plain loop
can lie apart by rounding alone, on the card, at B=1, T=128 and the
d-vector's widths (H=768, 256), both directions:

    python3 scripts/scan_spread.py [--seeds 1001 1002] [--relabellings 32]

For each case, of h_seq and of dxproj (the backward on the plain forward's
residuals): the kernel's largest distance from the plain loop; the plain
loop's own distances with its hidden units relabelled (the same network,
its sums in another order), how many of them are 0 and the largest; the
kernel's distances on the relabelled inputs; and where each first departs
from the plain loop in its order of steps (the step, its largest ulps
there, floored as in ``chip_smoke.py`` 8d, and how many elements differ).
A kernel that computes another function departs at its first step by more
than a rounding flip; one that sums in another order departs by a flip.
One JSON line per case, after the card's name and power limit. Needs a
CUDA card and ``nvcc``.

    python3 scripts/scan_spread.py --oracle [--seeds 1002] [--widths 768]

settles a departure: beside the kernel and the plain loop it runs a float64
oracle of the same rounding points (every product of bfloat16 values summed
in float64 and rounded to float32 once, then to bfloat16 where the plain
loop rounds), and gives each one's distance from the oracle and first
departure from it; and, at the step where the kernel's dxproj first leaves
the plain loop's, the dh carry that step reads (the one sum there whose
order differs: dgates of the step before times w_hh^T, 4H terms): for the
hidden units whose gate gradients differ, how far the exact carry lies from
the bfloat16 rounding boundary between the two values, in float32 ulps of
the carry, beside the float32 sum's error bound (4H x 2^-24 x the sum of
the terms' magnitudes, in the same ulps). A boundary nearer than the bound
is a flip that the order of a float32 sum decides: not a fault.

    python3 scripts/scan_spread.py --oracle --orders [--seeds 1000 ... 1005]

weighs the scan forward's order of summation instead: at the training
shapes (B=7, T=128; H = 512, 1024; xproj 0.5 x normal, then w_hh uniform in
+-1/sqrt(H), as ``chip_smoke.py`` 10b draws them), for each seed and width,
the share of h_seq's elements off the oracle and the first step where any
is, for the plain loop, the kernel, and copies of the kernel (built under
``build/scan_spread/``) that add its k16 partial sums otherwise: each eight
in sequence rather than pairwise, or all of K in one chain rather than two
halves. A float32 sum in another order flips a bfloat16 rounding now and
then, and the carry keeps the flip; the fewer flips, the nearer exact
arithmetic. One JSON line an engine.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from autovc_tpu_torch.ops import _build  # noqa: E402
from autovc_tpu_torch.ops import lstm as lstm_ops  # noqa: E402
from chip_smoke import BWD_FLOOR, bf16_ulps, gate_columns, labelled_back, relabelled, scan_plain  # noqa: E402

T, WIDTHS = 128, (768, 256)
ORDER_B, ORDER_WIDTHS = 7, (512, 1024)
# the scan forward's other orders of its k16 partial sums, as edits of csrc/lstm_scan_fwd.cu
PAIRWISE = """  if constexpr (G == 1)
    return d[C][i];
  else
    return pairwise<N, C, G / 2>(d, i) + pairwise<N, C + G / 2, G / 2>(d, i);"""
SEQUENCE = """  float r = d[C][i];
#pragma unroll
  for (int c = C + 1; c < C + G; ++c) r += d[c][i];
  return r;"""
HALVES = "const int steps = (a.H + 15) / 16, s0 = WG * steps / 2, s1 = (WG + 1) * steps / 2;"
ONE_CHAIN = "const int steps = (a.H + 15) / 16, s0 = WG == 0 ? 0 : steps, s1 = steps;"
ORDERS = {"eights in sequence": [(PAIRWISE, SEQUENCE)], "one chain over K": [(HALVES, ONE_CHAIN)]}


def kernels(x, w, dy, reverse, perm=None):
    """The scan forward's h_seq and the scan backward's dxproj on the plain
    forward's residuals, on inputs relabelled by ``perm`` (and back)."""
    if perm is not None:
        x, w, dy = relabelled(x, w, dy, perm)
    h_seq = lstm_ops.lstm_scan_forward_cuda(x, w, reverse=reverse)[0]
    _, c_seq, act, _, _ = lstm_ops.lstm_scan_bf16_train_ref(x, w, reverse=reverse)
    dx = lstm_ops.lstm_scan_backward_cuda(w, act.float(), c_seq.float(), None, dy, reverse=reverse)[0]
    if perm is not None:
        inv = torch.argsort(perm)
        h_seq, dx = h_seq[..., inv], dx[..., gate_columns(inv)]
    return h_seq, dx


def departure(got, want, steps, floor) -> list:
    """[step, ulps, elements differing] of the first step in ``steps`` where
    ``got`` leaves ``want``, or None."""
    for s in steps:
        g, v = got[:, s].float(), want[:, s].float()
        if not torch.equal(g, v):
            return [s, bf16_ulps(g, v, floor)[0], int((g != v).sum())]
    return None


def case(tag: str, x, w, dy, reverse: bool, relabellings: int) -> dict:
    hidden = w.shape[0]
    want = scan_plain(x, w, dy, reverse)
    got = kernels(x, w, dy, reverse)
    fwd_steps = range(T - 1, -1, -1) if reverse else range(T)
    bwd_steps = range(T) if reverse else range(T - 1, -1, -1)
    outs = (("h_seq", 0, 0, fwd_steps, 2.0 ** -16), ("dxproj", 3, 1, bwd_steps, BWD_FLOOR))
    rec = {"case": tag, "H": hidden, "reverse": reverse}
    own = {name: [] for name, *_ in outs}
    kernel_far = {name: [] for name, *_ in outs}
    for k in range(relabellings):
        perm = torch.from_numpy(np.random.RandomState(k).permutation(hidden)).to(x.device)
        plain_k = labelled_back(scan_plain(*relabelled(x, w, dy, perm), reverse), perm)
        kern_k = kernels(x, w, dy, reverse, perm)
        for name, i, j, steps, floor in outs:
            own[name].append((float((plain_k[i].float() - want[i].float()).abs().max()),
                              departure(plain_k[i], want[i], steps, floor)))
            kernel_far[name].append(float((kern_k[j].float() - want[i].float()).abs().max()))
    for name, i, j, steps, floor in outs:
        dists = [d for d, _ in own[name]]
        rec[name] = {"kernel": float((got[j].float() - want[i].float()).abs().max()),
                     "kernel_departs": departure(got[j], want[i], steps, floor),
                     "own_zero": sum(d == 0 for d in dists), "own_max": max(dists),
                     "own_departs": [p for _, p in own[name] if p is not None],
                     "kernel_relabelled": sorted(kernel_far[name])}
    return rec


def oracle_products(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``ops.lstm._products`` summed in float64 and rounded to float32 once."""
    if b.dim() == 2:
        return (a.double() @ b.double()).float()
    return torch.stack([(x.double() @ y.double()).float() for x, y in zip(a, b)])


def carry_margin(want, got, w, reverse: bool, steps) -> dict | None:
    """At the first step where the kernel's dxproj leaves the plain loop's:
    the exact carry into that step (the previous backward step's dgates @
    w_hh^T in float64), for each hidden unit whose gate gradients differ
    there, its distance from the bfloat16 rounding boundary between its two
    neighbouring bfloat16 values and the float32 sum's error bound, both in
    float32 ulps of the carry."""
    dep = departure(got, want, steps, BWD_FLOOR)
    if dep is None:
        return None
    s, hidden = dep[0], w.shape[0]
    order = list(steps)
    at = order.index(s)
    if at == 0:
        return {"step": s, "first_step": True}
    prev = order[at - 1]
    terms = want[:, prev].double()[..., :, None] * w.double().T[None]  # (B, 4H, H)
    exact = terms.sum(-2)[0]
    bound_abs = 4 * hidden * 2.0 ** -24 * terms.abs().sum(-2)[0]
    diff = (got[0, s].float() != want[0, s].float()).reshape(4, hidden).any(0)
    units = torch.nonzero(diff).flatten().tolist()
    rows = []
    for j in units:
        v = float(exact[j])
        lo = float(torch.tensor(v, dtype=torch.float64).to(torch.float32).to(torch.bfloat16).float())
        e = np.float32(abs(v)) if v else np.float32(1e-38)
        ulp32 = float(np.spacing(e))
        ulp16 = float(np.spacing(np.float32(abs(lo) if lo else 1e-38))) * 2.0 ** 16
        mid = lo + (ulp16 / 2 if v >= lo else -ulp16 / 2)
        rows.append({"unit": j, "carry": v, "to_boundary_ulp32": abs(v - mid) / ulp32,
                     "f32_bound_ulp32": float(bound_abs[j]) / ulp32})
    return {"step": s, "units": rows}


def oracle_case(tag: str, x, w, dy, reverse: bool) -> dict:
    """The kernel, the plain loop and the float64 oracle of the same
    rounding points: each one's distance from the oracle and first
    departure from it, for h_seq and dxproj, and the carry at the kernel's
    first departure from the plain loop (``carry_margin``)."""
    want = scan_plain(x, w, dy, reverse)
    got = kernels(x, w, dy, reverse)
    saved = lstm_ops._products
    lstm_ops._products = oracle_products
    try:
        exact = scan_plain(x, w, dy, reverse)
    finally:
        lstm_ops._products = saved
    fwd_steps = range(T - 1, -1, -1) if reverse else range(T)
    bwd_steps = range(T) if reverse else range(T - 1, -1, -1)
    rec = {"case": tag, "H": w.shape[0], "reverse": reverse, "oracle": True}
    for name, i, j, steps, floor in (("h_seq", 0, 0, fwd_steps, 2.0 ** -16), ("dxproj", 3, 1, bwd_steps, BWD_FLOOR)):
        rec[name] = {"kernel_from_plain": float((got[j].float() - want[i].float()).abs().max()),
                     "kernel_from_oracle": float((got[j].float() - exact[i].float()).abs().max()),
                     "plain_from_oracle": float((want[i].float() - exact[i].float()).abs().max()),
                     "kernel_departs_oracle": departure(got[j], exact[i], steps, floor),
                     "plain_departs_oracle": departure(want[i], exact[i], steps, floor)}
    rec["dxproj"]["carry_at_kernel_departure"] = carry_margin(want[3], got[1], w, reverse, bwd_steps)
    return rec


def oracle_forward(x, w):
    """The scan forward's plain loop with ``oracle_products``."""
    saved = lstm_ops._products
    lstm_ops._products = oracle_products
    try:
        return lstm_ops.lstm_scan_bf16_ref(x, w)
    finally:
        lstm_ops._products = saved


def build_order(name: str, edits: list[tuple[str, str]]) -> ctypes.CDLL:
    """A copy of the scan forward's kernel with ``edits`` made to its source."""
    src = (_build.CSRC / "lstm_scan_fwd.cu").read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"lstm_scan_fwd.cu has changed: {old!r} is not there once")
        src = src.replace(old, new)
    out = ROOT / "build" / "scan_spread"
    out.mkdir(parents=True, exist_ok=True)
    stem = name.replace(" ", "_")
    (out / f"{stem}.cu").write_text(src)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_build.find_nvcc(), *flags, "-I", str(_build.CSRC), "-o", str(out / f"{stem}.so"),
                    str(out / f"{stem}.cu")], check=True)
    return ctypes.CDLL(str(out / f"{stem}.so"))


def off_oracle(got: torch.Tensor, exact: torch.Tensor) -> tuple[float, int]:
    """The share of h_seq's elements off the oracle, and the first step with one (T if none)."""
    off = got.float() != exact.float()
    steps = off.any(dim=0).any(dim=-1).nonzero()
    return float(off.float().mean()), int(steps[0]) if len(steps) else T


def orders(seeds: list[int]) -> None:
    """The --orders lines (see the module's notes)."""
    dev = torch.device("cuda")
    cases = []
    for seed in seeds:
        for hidden in ORDER_WIDTHS:
            rng = np.random.RandomState(seed)
            x = torch.from_numpy((rng.randn(ORDER_B, T, 4 * hidden) * 0.5).astype(np.float32)).to(dev).bfloat16()
            lim = 1.0 / np.sqrt(hidden)
            w = torch.from_numpy(rng.uniform(-lim, lim, (hidden, 4 * hidden)).astype(np.float32)).to(dev).bfloat16()
            cases.append((x, w, oracle_forward(x, w)))
    results = {"plain loop": [off_oracle(lstm_ops.lstm_scan_bf16_ref(x, w), e) for x, w, e in cases],
               "kernel": [off_oracle(lstm_ops.lstm_scan_forward_cuda(x, w)[0], e) for x, w, e in cases]}
    kernel_lib = _build.load("lstm_scan_fwd")
    try:
        for name, edits in ORDERS.items():
            _build._loaded["lstm_scan_fwd"] = build_order(name, edits)
            results[f"kernel, {name}"] = [off_oracle(lstm_ops.lstm_scan_forward_cuda(x, w)[0], e)
                                          for x, w, e in cases]
    finally:
        _build._loaded["lstm_scan_fwd"] = kernel_lib
    for name, rows in results.items():
        print(json.dumps({"engine": name, "B": ORDER_B, "T": T, "widths": ORDER_WIDTHS, "seeds": seeds,
                          "share_off_oracle_mean": float(np.mean([r[0] for r in rows])),
                          "share_off_oracle": [round(r[0], 5) for r in rows],
                          "first_departure_step_mean": float(np.mean([r[1] for r in rows])),
                          "first_departure_step": [r[1] for r in rows]}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1001, 1002])
    ap.add_argument("--relabellings", type=int, default=32)
    ap.add_argument("--widths", type=int, nargs="+", default=list(WIDTHS))
    ap.add_argument("--oracle", action="store_true",
                    help="the float64 oracle of the same rounding points instead of the relabellings")
    ap.add_argument("--orders", action="store_true",
                    help="with --oracle: the scan forward's orders of summation at the training shapes")
    args = ap.parse_args()
    if args.orders and not args.oracle:
        ap.error("--orders goes with --oracle")
    if not torch.cuda.is_available():
        raise SystemExit("scan_spread: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)
    if args.orders:
        orders(args.seeds)
        return
    dev, bf16 = torch.device("cuda"), torch.bfloat16
    for seed in args.seeds:
        rng = np.random.RandomState(seed)
        for hidden in WIDTHS:
            lim = 1.0 / np.sqrt(hidden)
            w = torch.from_numpy(rng.uniform(-lim, lim, (hidden, 4 * hidden)).astype(np.float32)).to(dev).to(bf16)
            x = torch.from_numpy((rng.randn(1, T, 4 * hidden) * 0.5).astype(np.float32)).to(dev).to(bf16)
            dy = torch.from_numpy(rng.randn(1, T, hidden).astype(np.float32)).to(dev).to(bf16)
            if hidden not in args.widths:
                continue  # drawn all the same, so that a seed's inputs do not depend on --widths
            for reverse in (False, True):
                rec = (oracle_case(f"seed {seed}", x, w, dy, reverse) if args.oracle
                       else case(f"seed {seed}", x, w, dy, reverse, args.relabellings))
                print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
