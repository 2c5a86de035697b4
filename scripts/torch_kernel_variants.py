"""Device time of K1, K2, K3a and K5 against variants of their own sources,
on one CUDA card.

    python3 scripts/torch_kernel_variants.py [PARENT_TREE]

Builds copies of ``csrc/window_slice.cu`` (K1), ``csrc/segment_moments.cu``
(K2), ``csrc/ndt_linearize.cu`` (K3a) and ``csrc/segment_sum.cu`` (K5) with
one change each (``VARIANTS``) and, with PARENT_TREE (an earlier checkout,
unpacked with ``git archive``), that tree's sources of the four kernels.
K2's and K3a's have the same C interface.  The parent's K1 takes int32 row
starts and its K5 sums runs that a plain stable sort and binary search lay
out, so for those two the parent's whole call is timed: the int32 cast and
the kernel (K1); the sort, search and casts of its ``segment_order`` and the
kernel (K5).  K2's kernel run over every segment (``topi`` = 0..S-1, the
ids cast to int32 beforehand) is timed as a K5 design too.  Each variant
that computes the same function is checked against the plain version (K1
bitwise), and K3b (which shares K3a's source) bitwise against the parent
tree's; the diagnostic ones leave part of the work out to show where the
time goes, and their results are not checked.  Then each call's median
device time (``chip_smoke.device_ms``) is printed in three alternating
rounds, beside the launch floor, at the Oxford shapes: K1 on
``chip_smoke.py``'s rendered frame (A = 400, R = 1,221, win = 65); K2 at
P = 26,000 points, k = 512 kept segments, 13 channels, on a seeded set
(S = 3,249 segments) and on the rendered frame; K3a at W = 3 slots of
N = 2048 pairs; K5 at P = 26,000, S = 3,249, 13 channels on the dense
seeded set of ``chip_smoke.py`` (int32 ids) and on the rendered frame
(int64 ids, 1,804 kept).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

K3A_FOLD = """  float sum[fold_width(kTerms, 16)];
  int term, held;
  warp_fold<kTerms, 16>(acc, lane, 0, kTerms, sum, term, held);
  if (held > 0) warp_part[t / 32][term] = sum[0];"""
SHUFFLE_TREES = """#pragma unroll
  for (int k = 0; k < kTerms; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kTerms; ++k) warp_part[t / 32][k] = acc[k];
  }"""
K2_FOLD = """  float sum[fold_width(kTerms, 16)];
  int base, held;
  warp_fold<kTerms, 16>(acc, lane, 0, kTerms, sum, base, held);
#pragma unroll
  for (int j = 0; j < fold_width(kTerms, 16); ++j) {
    if (j < held) warp_part[t / 32][base + j] = sum[j];
  }"""
# four consecutive points a thread, as one 16-byte load of their ids
K2_SCAN = ("  // thread t takes the points p = t,", "  // warp: the transposing fold")
K2_QUADS = """  const int nq = P / 4;  // ids 16-byte aligned, as a new tensor's are
  const int4* ids4 = reinterpret_cast<const int4*>(ids);
  for (int q0 = t; q0 < nq; q0 += kThreads * (kBatch / 4)) {
    int4 x[kBatch / 4];
#pragma unroll
    for (int u = 0; u < kBatch / 4; ++u) {
      const int q = q0 + u * kThreads;
      x[u] = q < nq ? ids4[q] : make_int4(0, 0, 0, 0);
    }
    unsigned hits = 0;
#pragma unroll
    for (int u = 0; u < kBatch / 4; ++u) {
      if (q0 + u * kThreads < nq) {
        hits |= (static_cast<unsigned>(hit(x[u].x)) | hit(x[u].y) << 1
                 | hit(x[u].z) << 2 | hit(x[u].w) << 3) << (4 * u);
      }
    }
    while (hits != 0) {
      const int j = __ffs(hits) - 1;
      hits &= hits - 1;
      const int p = 4 * (q0 + (j / 4) * kThreads) + j % 4;
      add(p, ids[p]);
    }
  }
  for (int p = 4 * nq + t; p < P; p += kThreads) {
    if (hit(ids[p])) add(p, ids[p]);
  }

"""
# K5's lanes of one segment found by ballots over the bits of their place
MATCH_BY_BALLOTS = """__device__ __forceinline__ unsigned match_lanes(int key, int bits) {
  unsigned eq = 0xffffffffu;
  for (int b = 0; b < bits; ++b) {
    const bool one = (key >> b) & 1;
    const unsigned ones = __ballot_sync(0xffffffffu, one);
    eq &= one ? ones : ~ones;
  }
  return eq;
}

template <typename Id>
__global__"""
# name -> (source, [(text or (from, up to), replacement)], diagnostic)
VARIANTS = {
    "k2 256 threads a block": (
        "segment_moments", [("kThreads = 512;", "kThreads = 256;")], False),
    "k2 16-byte id loads, four points a thread": (
        "segment_moments", [(K2_SCAN, K2_QUADS)], False),
    "k2 one shuffle tree per sum": ("segment_moments", [(K2_FOLD, SHUFFLE_TREES)], False),
    "k2 without the row adds": (
        "segment_moments", [("      add(p, ids[p]);\n",
                             "      acc[0] += static_cast<float>(p);\n")], True),
    "k2 without the id scan": (
        "segment_moments", [("for (int p0 = t; p0 < P;", "for (int p0 = P + t; p0 < P;")],
        True),
    "k3a one shuffle tree per sum": ("ndt_linearize", [(K3A_FOLD, SHUFFLE_TREES)], False),
    "k1 8 rows a block": ("window_slice", [("kRows = 4;", "kRows = 8;")], False),
    "k1 one column a lane before its store": (
        "window_slice", [("kPerLane = 4;", "kPerLane = 1;")], False),
    "k5 128 segments a cluster": ("segment_sum", [("kSlice = 256;", "kSlice = 128;")],
                                  False),
    "k5 one ballot per bit of the place in place of __match_any_sync": (
        "segment_sum", [("template <typename Id>\n__global__", MATCH_BY_BALLOTS),
                        ("__match_any_sync(0xffffffffu, j)", "hits & match_lanes(j, 8)")], False),
    "k5 without the gather and the sums": (
        "segment_sum", [("for (int base = 0; base < total;", "for (int base = total; base < total;")],
        True),
    "k5 without the list, the gather and the sums": (
        "segment_sum", [("for (int base = 0; base < total;", "for (int base = total; base < total;"),
                        ("for (int p0 = lo; p0 < hi; p0 += 32) {",
                         "for (int p0 = hi; p0 < hi; p0 += 32) {")], True),
}
PARENT_SOURCES = (("segment_moments", "k2"), ("ndt_linearize", "k3a"),
                  ("window_slice", "k1"), ("segment_sum", "k5"))


def build_variants(parent):
    from randt_slam_torch.ops import build

    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {}
    for name, (src, edits, _) in VARIANTS.items():
        text = (build.CSRC / f"{src}.cu").read_text()
        for old, new in edits:
            start, end = old if isinstance(old, tuple) else (old, None)
            a = text.find(start)
            b = a + len(start) if end is None else text.find(end, a)
            if a < 0 or b < 0:
                raise RuntimeError(f"{name}: the text to replace is not in {src}.cu")
            # a plain text is replaced wherever it stands
            text = (text.replace(start, new) if end is None
                    else text[:a] + new + text[b:])
        sources[name] = text
    if parent:
        for src, label in PARENT_SOURCES:
            path = os.path.join(parent, "randt_slam_torch", "csrc", f"{src}.cu")
            with open(path) as f:
                sources[f"{label} parent tree"] = f.read()
    procs = {}
    for i, (name, text) in enumerate(sources.items()):
        cu, so = out_dir / f"variant{i}.cu", out_dir / f"libvariant{i}.so"
        cu.write_text(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = "; ".join(ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                         if "registers" in ln)
        print(f"built {name}: {regs}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from randt_slam_torch.config import oxford_config
    from randt_slam_torch.ops import build
    from randt_slam_torch.ops import ndt_linearize as NL
    from randt_slam_torch.ops import segment_moments as K2
    from randt_slam_torch.ops import window_slice as K1

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    libs = build_variants(os.path.abspath(sys.argv[1]) if len(sys.argv) > 1 else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    p, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int

    # K2 at the Oxford shape: a seeded set made as chip_smoke makes its own,
    # and chip_smoke's rendered frame (its points ordered by azimuth and
    # range, so that a segment's points lie in runs)
    cfg = oxford_config()
    S, k = cfg.preprocessor.cluster_row_size ** 2, cfg.capacity.max_scan_cells
    rng = np.random.default_rng(1)
    P = 26000
    vals = rng.normal(0, 30, (P, 13)).astype(np.float32)
    vals[:, 0] = (rng.random(P) < 0.3).astype(np.float32)
    seeded = (torch.from_numpy(vals).to(dev),
              torch.from_numpy(rng.integers(-1, S + 1, P)).to(dev), S, k)
    scans, az, ranges, _, _ = CS.render_frames(CS.N_RENDER)
    k1_frame, frame, _ = CS.frame_inputs(cfg, scans[CS.N_RENDER // 2], az, ranges, dev)
    k2_sets = {}
    for label, (v, ids, num, kk) in (("seeded", seeded), ("frame", frame)):
        _, topi = K2.segment_topk_moments(v, ids, num, kk)
        ids32 = torch.where((ids >= 0) & (ids < num), ids, -1).to(torch.int32)
        k2_sets[label] = (v.contiguous(), ids32, topi.to(torch.int32),
                          K2.topi_moments_plain(v, ids, topi, num),
                          K2.topi_moments_plain(v.abs(), ids, topi, num))

    def k2_call(fn, label):
        fn.argtypes = [p, p, p, p, i, i, i, p]
        fn.restype = i
        v, ids32, topi32 = k2_sets[label][:3]

        def call():
            out = torch.empty((topi32.shape[0], v.shape[1]), device=dev)
            if fn(v.data_ptr(), ids32.data_ptr(), topi32.data_ptr(), out.data_ptr(),
                  v.shape[0], v.shape[1], topi32.shape[0], stream) != 0:
                raise RuntimeError("K2 variant launch failed")
            return out
        return call

    # K3a at W = 3, N = 2048 on random pairs, 70 % valid
    rng3 = np.random.default_rng(3)
    W, N = 3, 2048
    m_mean = rng3.uniform(-60, 60, (W, N, 3))
    cov = rng3.normal(0, 0.5, (2, W, N, 3, 3))
    cov = cov @ np.swapaxes(cov, -1, -2) + 0.05 * np.eye(3)
    pairs = [torch.tensor(x, dtype=torch.float32, device=dev) for x in
             (m_mean, cov[0], m_mean + rng3.normal(0, 1.0, (W, N, 3)), cov[1])]
    packed = NL.pack_pairs(*pairs, torch.from_numpy(rng3.random((W, N)) < 0.7).to(dev))
    pose4 = NL.pose_inputs(torch.tensor(rng3.normal(0, 0.3, (W, 3)),
                                        dtype=torch.float32, device=dev))
    mu, ns = torch.tensor(2.0, device=dev), torch.tensor(0.4, device=dev)
    sc, al = cfg.matcher.loss_function_scale, cfg.matcher.loss_function_convexity
    k3_plain = NL.linearize_plain(pose4, mu, ns, packed, sc, al)
    k3_scale = NL.sums_to_blocks(
        NL.linearize_terms(pose4, mu, ns, packed, sc, al).abs().sum(-1))

    def k3a_call(fn):
        fn.argtypes = [p] * 11 + [i, i] + [f, f, f, i, f, f, f] + [p]
        fn.restype = i

        def call():
            H = torch.empty((W, 3, 3), device=dev)
            g = torch.empty((W, 3), device=dev)
            rho = torch.empty((W,), device=dev)
            if fn(pose4.data_ptr(), mu.data_ptr(), ns.data_ptr(),
                  *(x.data_ptr() for x in packed), H.data_ptr(), g.data_ptr(),
                  rho.data_ptr(), W, N, *NL._barron_args(sc, al, 1e-12), stream) != 0:
                raise RuntimeError("K3a variant launch failed")
            return H, g, rho
        return call

    # K1 on the rendered frame: the shipped kernel reads int64 starts; the
    # parent tree's kernel reads int32, so its call casts them first
    img, rng_row, starts, win = k1_frame
    A, R = img.shape
    k1_plain = K1.row_windows_plain(img, rng_row, starts, win)

    def k1_call(fn, int32):
        fn.argtypes = [p, p, p, p, p, i, i, i, p]
        fn.restype = i

        def call():
            st = starts.to(torch.int32) if int32 else starts
            oi = torch.empty((A, win), device=dev)
            orng = torch.empty((A, win), device=dev)
            if fn(img.data_ptr(), rng_row.data_ptr(), st.data_ptr(), oi.data_ptr(),
                  orng.data_ptr(), A, R, win, stream) != 0:
                raise RuntimeError("K1 variant launch failed")
            return oi, orng
        return call

    # K5 at P = 26,000, S = 3,249: chip_smoke's dense seeded set (int32
    # ids) and the rendered frame's points (int64 ids, 1,804 kept)
    r5 = np.random.default_rng(P)
    k5_sets = {
        "dense": (torch.from_numpy(r5.normal(0, 30, (P, 13)).astype(np.float32)).to(dev),
                  torch.from_numpy(r5.integers(-1, S + 2, P).astype(np.int32)).to(dev)),
        "frame": (frame[0].contiguous(), frame[1]),
    }
    k5_ref = {label: (K2.segment_moments_plain(v, ids, S),
                      K2.segment_moments_plain(v.abs(), ids, S))
              for label, (v, ids) in k5_sets.items()}

    def k5_call(lib, label):
        v, ids = k5_sets[label]
        fn = (lib.segment_sum_i64_f32 if ids.dtype == torch.int64
              else lib.segment_sum_i32_f32)
        fn.argtypes = [p, p, p, i, i, i, p]
        fn.restype = i

        def call():
            out = torch.empty((S, v.shape[1]), device=dev)
            if fn(v.data_ptr(), ids.data_ptr(), out.data_ptr(),
                  v.shape[0], S, v.shape[1], stream) != 0:
                raise RuntimeError("K5 variant launch failed")
            return out
        return call

    def k5_parent_call(lib, label):
        """The parent tree's whole call: its plain segment_order (stable
        sort, binary search, two casts), then its kernel over the runs."""
        v, ids = k5_sets[label]
        fn = lib.segment_sum_f32
        fn.argtypes = [p, p, p, p, i, i, p]
        fn.restype = i
        bounds = torch.arange(S + 1, device=dev)

        def call():
            ok = (ids >= 0) & (ids < S)
            key = torch.where(ok, ids, S).long()
            sorted_key, perm = torch.sort(key, stable=True)
            perm = perm.to(torch.int32)
            offsets = torch.searchsorted(sorted_key, bounds).to(torch.int32)
            out = torch.empty((S, v.shape[1]), device=dev)
            if fn(v.data_ptr(), perm.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                  S, v.shape[1], stream) != 0:
                raise RuntimeError("K5 parent launch failed")
            return out
        return call

    def k5_k2_call(label):
        """K2's design as a K5: its kernel over topi = 0..S-1, with the ids
        cast to int32 (-1 for dropped) beforehand, outside the timing."""
        v, ids = k5_sets[label]
        ids32 = torch.where((ids >= 0) & (ids < S), ids, -1).to(torch.int32)
        every = torch.arange(S, dtype=torch.int32, device=dev)
        return lambda: K2.topi_moments_cuda(v, ids32, every)

    k2_fns = {"k2 shipped": K2._lib(),
              **{n: lib.topi_moments_f32 for n, lib in libs.items() if n.startswith("k2")}}
    # row name -> (call, variant, check of two outputs or None)

    def k2_check(label):
        plain, scale = k2_sets[label][3:]
        return lambda a, b: torch.equal(a, b) and bool(((a - plain).abs() <= 1e-5 * scale).all())

    def k3_check(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b)) and all(
            bool(((x - y).abs() <= CS.K3_REL * s).all())
            for x, y, s in zip(a, k3_plain, k3_scale))

    def k1_check(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b)) and all(
            torch.equal(x, y) for x, y in zip(a, k1_plain))

    def k5_check(label):
        plain, scale = k5_ref[label]
        return lambda a, b: torch.equal(a, b) and bool(((a - plain).abs() <= 1e-5 * scale).all())

    calls = {f"{name}, {label} set": (k2_call(fn, label), name, k2_check(label))
             for name, fn in k2_fns.items() for label in k2_sets}
    calls["k3a shipped"] = (k3a_call(NL._fn("ndt_linearize_f32")), "k3a shipped", k3_check)
    calls.update({n: (k3a_call(lib.ndt_linearize_f32), n, k3_check)
                  for n, lib in libs.items() if n.startswith("k3a")})
    calls["k1 shipped"] = (k1_call(K1._lib(), False), "k1 shipped", k1_check)
    for n, lib in libs.items():
        if n.startswith("k1"):
            calls[n + (" (int32 cast and kernel)" if n == "k1 parent tree" else "")] = (
                k1_call(lib.row_windows_f32, n == "k1 parent tree"), n, k1_check)
    k5_libs = {"k5 shipped": build.library("segment_sum"),
               **{n: lib for n, lib in libs.items() if n.startswith("k5")}}
    for label in k5_sets:
        for n, lib in k5_libs.items():
            if n == "k5 parent tree":
                calls[f"{n} (sort, search, casts and kernel), {label} set"] = (
                    k5_parent_call(lib, label), n, k5_check(label))
            else:
                calls[f"{n}, {label} set"] = (k5_call(lib, label), n, k5_check(label))
        calls[f"k5 as K2's kernel over every segment, {label} set"] = (
            k5_k2_call(label), "k5 as K2's kernel", k5_check(label))
    diagnostic = {n for n, (_, _, diag) in VARIANTS.items() if diag}
    for name, (call, variant, check) in calls.items():
        if variant in diagnostic:
            continue
        a, b = call(), call()
        torch.cuda.synchronize()
        if not check(a, b):
            raise AssertionError(f"{name}: differs from plain or between launches")
    print("every variant that computes the function agrees with plain and "
          "repeats bitwise", flush=True)
    if "k3a parent tree" in libs:  # K3b shares K3a's source: unchanged?
        outs = []
        parent_k3b = libs["k3a parent tree"].ndt_robust_cost_f32
        for fn in (NL._fn("ndt_robust_cost_f32"), parent_k3b):
            fn.argtypes = [p] * 9 + [i, i] + [f, f, f, i, f, f, f] + [p]
            fn.restype = i
            rho, r2max = torch.empty(W, device=dev), torch.empty(W, device=dev)
            if fn(pose4.data_ptr(), mu.data_ptr(), *(x.data_ptr() for x in packed),
                  rho.data_ptr(), r2max.data_ptr(), W, N,
                  *NL._barron_args(sc, al, 1e-12), stream) != 0:
                raise RuntimeError("K3b launch failed")
            outs.append((rho, r2max))
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(*outs)):
            raise AssertionError("K3b differs from the parent tree's")
        print("K3b bitwise equal to the parent tree's", flush=True)

    times = {name: [] for name in calls}
    floor = []
    for _ in range(3):
        floor.append(CS.device_ms(lambda: torch.cuda._sleep(0)))
        for name, (call, _, _) in calls.items():
            times[name].append(CS.device_ms(call))
    print(f"launch floor: {', '.join(f'{t * 1e3:.2f}' for t in floor)} us", flush=True)
    for name, ts in times.items():
        diag = " (diagnostic)" if calls[name][1] in diagnostic else ""
        print(f"{name}{diag}: {', '.join(f'{t * 1e3:.2f}' for t in ts)} us", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
