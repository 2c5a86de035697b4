"""Device time of K2 and K3a against variants of their own sources, on one
CUDA card.

    python3 scripts/torch_kernel_variants.py [PARENT_TREE]

Builds copies of ``csrc/segment_moments.cu`` (K2) and ``csrc/ndt_linearize.cu``
(K3a) with one change each (``VARIANTS``) and, with PARENT_TREE (an earlier
checkout, unpacked with ``git archive``), that tree's sources of the two
kernels, which have the same C interface.  Each variant that computes the
same function is checked against the plain version, and K3b (which shares
K3a's source) bitwise against the parent tree's; the diagnostic ones
leave part of the work out to show where the time goes, and their results
are not checked.  Then each library's median device time
(``chip_smoke.device_ms``) is printed in three alternating rounds, beside
the launch floor, at the Oxford shapes: K2 at P = 26,000 points, k = 512
kept segments, 13 channels, on a seeded set (S = 3,249 segments) and on
``chip_smoke.py``'s rendered frame; K3a at W = 3 slots of N = 2048 pairs.
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
}


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
            text = text[:a] + new + text[b:]
        sources[name] = text
    if parent:
        for src, label in (("segment_moments", "k2"), ("ndt_linearize", "k3a")):
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
    from randt_slam_torch.ops import ndt_linearize as NL
    from randt_slam_torch.ops import segment_moments as K2

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
    frame = CS.frame_inputs(cfg, scans[CS.N_RENDER // 2], az, ranges, dev)[1]
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

    k2_fns = {"k2 shipped": K2._lib(),
              **{n: lib.topi_moments_f32 for n, lib in libs.items() if n.startswith("k2")}}
    # row name -> (call, variant, K2 input set or None)
    calls = {f"{name}, {label} set": (k2_call(fn, label), name, label)
             for name, fn in k2_fns.items() for label in k2_sets}
    calls["k3a shipped"] = (k3a_call(NL._fn("ndt_linearize_f32")), "k3a shipped", None)
    calls.update({n: (k3a_call(lib.ndt_linearize_f32), n, None)
                  for n, lib in libs.items() if n.startswith("k3a")})
    diagnostic = {n for n, (_, _, diag) in VARIANTS.items() if diag}
    for name, (call, variant, label) in calls.items():
        if variant in diagnostic:
            continue
        a, b = call(), call()
        torch.cuda.synchronize()
        if label is not None:
            plain, scale = k2_sets[label][3:]
            ok = torch.equal(a, b) and bool(((a - plain).abs() <= 1e-5 * scale).all())
        else:
            ok = all(torch.equal(x, y) for x, y in zip(a, b)) and all(
                bool(((x - y).abs() <= CS.K3_REL * s).all())
                for x, y, s in zip(a, k3_plain, k3_scale))
        if not ok:
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
