#!/usr/bin/env python3
"""The bf16 wide K3 (csrc/ce_wide_fwd.cu) as built, with h's tile
resident and with other ring sizes, timed on one card.

    python3 scripts/ce_wide_fwd_variants.py [--iters 20]

Each variant is an edited copy of `csrc/ce_wide_fwd.cu` (each edit a text
replacement that must match the source once, or the text between two
markers), built with the port's nvcc
flags in a temporary directory and called through the port's wrapper
(`ce_kernel.ce_fwd`, its bound launch function replaced by the variant's,
the vocab splits from the variant's own tiling) on chip_smoke.py's inputs,
N = 1,984, V = 22,234, bf16:
- `streamed` (as built): a ring of 3 stages, each a 64-column k-chunk of
  h's 64-row tile and of W's 128-row tile (24 KB), three blocks an SM;
- `resident_h`: h's whole tile loaded once (8 KB a 64-column slab, 80 KB at
  D = 640, on a barrier of its own) and a ring of 2 stages of W's chunk
  alone (16 KB): a third less read a vocab tile, fewer blocks an SM;
- `stages_4`, `stages_2`: the streamed ring with 4 or 2 stages (96 KB: two
  blocks an SM; 48 KB: three, as registers allow).
Prints each variant's device time per call (`chip_smoke.device_ms`) and its
largest error against the plain version at D = 200, 512 and 640, the
blocks an SM its tiling reports, `F.cross_entropy(h @ W^T + b)`'s device
time on the same inputs, and the card's name and power limit. Needs CUDA.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from deepsc_gan_tpu_torch.ops import build  # noqa: E402
from deepsc_gan_tpu_torch.ops import ce_kernel as ce  # noqa: E402

N, V = 1984, 22234
WIDTHS = (200, 512, 640)
# the resident_h variant's kernel: h's 64-row tile loaded once, W's chunks
# through a ring of 2 stages
RESIDENT_H = r"""constexpr int kStages = 2;
constexpr int kHBytes = wg::kRows * wg::kRowBytes;  // a k-chunk of h: 8 KB
constexpr int kWBytes = kTV * wg::kRowBytes;        // of W: 16 KB
constexpr int kStageBytes = kWBytes;

// dynamic shared memory a block needs (the same at every width)
size_t smem_bytes(int dp) {
  return 1024 + (size_t)wg::slabs(dp) * kHBytes +
         (size_t)kStages * kStageBytes;
}

__device__ __forceinline__ void wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// block (row tile, vocab split): (max, sum, gold) of its 64 rows over its
// vocab tiles, into part[split]
__global__ void __launch_bounds__(wg::kThreads)
ce_fwd_wide_tc_kernel(const __grid_constant__ CUtensorMap hmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const float* __restrict__ b,
                      const int* __restrict__ labels,
                      float* __restrict__ part, int n, int dp, int v,
                      int tiles_per_split) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bar[kStages + 1];
  uint8_t* hres = wg::align_1024(smem_raw);
  uint8_t* ring = hres + wg::slabs(dp) * kHBytes;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * wg::kRows;
  const int split = blockIdx.y;
  const int nvt = (v + kTV - 1) / kTV;
  const int t0 = split * tiles_per_split;
  const int count = min(t0 + tiles_per_split, nvt) - t0;
  const int nk = wg::slabs(dp);         // k-chunks of 64 columns a tile
  const int ksteps = (dp + 15) / 16;    // k-steps of 16 that hold data
  const int total = count * nk;         // chunks the block streams

  // chunk j (k-chunk j % nk of vocab tile t0 + j / nk) -> stage j % kStages
  auto load = [&](int j) {
    uint8_t* st = ring + (j % kStages) * kStageBytes;
    uint64_t* bj = &bar[j % kStages];
    const int col = (j % nk) * wg::kSlabCols;
    wg::mbar_expect_tx(bj, kStageBytes);
    wg::load_box(st, &wmap, bj, col, (t0 + j / nk) * kTV);
  };
  // every warp's products of chunk j are done: refill its stage
  auto release = [&](int j) {
    __syncthreads();
    if (tid == 0 && j + kStages < total) load(j + kStages);
  };

  if (tid == 0) {
    for (int i = 0; i <= kStages; ++i) wg::mbar_init(&bar[i], 1);
    wg::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    wg::load_tile(hres, &hmap, &bar[kStages], row0, wg::kRows, dp);
    for (int j = 0; j < kStages && j < total; ++j) load(j);
  }

  const int r = (tid >> 5) * 16 + (lane >> 2);
  ceo::Softmax sm;
  sm.init(labels, row0 + r, n);
  wg::mbar_wait(&bar[kStages], 0);
  const uint32_t h_addr = wg::smem_u32(hres);
  const uint32_t ring_addr = wg::smem_u32(ring);
  for (int it = 0; it < count; ++it) {
    const int col0 = (t0 + it) * kTV;
    const int c0 = col0 + 2 * (lane & 3);
    float bias[32];
    ceo::load_bias(bias, b, col0, c0, v);
    float acc[64];
    wg::fence_regs(acc);
    for (int kc = 0; kc < nk; ++kc) {
      const int j = it * nk + kc;
      wg::mbar_wait(&bar[j % kStages], (j / kStages) & 1);
      const uint32_t w = ring_addr + (j % kStages) * kStageBytes;
      const uint32_t a = h_addr + kc * kHBytes;
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (4 * kc + kk < ksteps)
          wg::mma_ss_n128(acc, wg::desc_k(a, wg::kRows, kk),
                          wg::desc_k(w, kTV, kk), kc > 0 || kk > 0);
      wg::commit();
      if (kc > 0) {
        wait_one();
        release(j - 1);
      }
    }
    wg::wait_all();
    wg::fence_regs(acc);
    release(it * nk + nk - 1);
    sm.add_tile(acc, bias, col0, c0, v);
  }
  sm.store(part, split, row0 + r, n, lane);
}

"""

VARIANTS = {
    "streamed": [],
    "resident_h": [
        # the ring of csrc/ce_online.cuh replaced by the kernel's own loop
        # over a resident h and a ring of W's chunks alone
        (("constexpr int kStages = 3;", "bool takes(int dp)"), RESIDENT_H),
        ("out[2] = (int)smem_bytes();", "out[2] = (int)smem_bytes(dp);"),
        ("smem_bytes(), wg::kRows", "smem_bytes(dp), wg::kRows"),
        ("const size_t smem = smem_bytes();",
         "const size_t smem = smem_bytes(dp);")],
    "stages_4": [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
    "stages_2": [("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
}


def build_variants(tmp: Path) -> dict:
    """Each variant's (launch, tiling) functions, their nvcc processes
    started together."""
    text = (build.CSRC / f"{ce.KERNEL_WIDE_FWD}.cu").read_text()
    jobs = {}
    for name, edits in VARIANTS.items():
        s = text
        for old, new in edits:
            if isinstance(old, tuple):  # the text from old[0] up to old[1]
                start = s.find(old[0])
                old = s[start:s.find(old[1], start)] if start >= 0 else "\0"
            if s.count(old) != 1:
                raise RuntimeError(f"{name}: an edit does not match the "
                                   f"source once: {old!r}")
            s = s.replace(old, new)
        path, lib = tmp / f"k3_{name}.cu", tmp / f"libk3_{name}.so"
        path.write_text(s)
        cmd = build.nvcc_command(path, lib, build.find_nvcc())
        cmd[1:1] = ["-I", str(build.CSRC)]
        jobs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        so = ctypes.CDLL(str(lib))
        fn = so.deepsc_ce_wide_fwd_bf16
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        tiling = so.deepsc_ce_wide_fwd_tiling_bf16
        tiling.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        tiling.restype = ctypes.c_int
        fns[name] = (fn, tiling)
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ce_wide_fwd_variants: CUDA is not available", file=sys.stderr)
        return 1
    cs.phase_device()
    bf16 = torch.bfloat16
    dev = torch.device("cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    inputs = {d: cs.ce_inputs(bf16, gen, N, d, V)[:4] for d in WIDTHS}
    for d, (h, W, b, labels) in inputs.items():
        ms = cs.device_ms(lambda: F.cross_entropy(
            (h @ W.t()).float() + b, labels, reduction="none"), args.iters)
        print(f"[k3] library D={d} device_ms {ms!r}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for name, (fn, tiling) in build_variants(Path(tmp)).items():
            ce._BOUND[(ce.KERNEL_WIDE_FWD, bf16)] = fn
            for d, (h, W, b, labels) in inputs.items():
                out = (ctypes.c_int * 3)()
                if tiling(d, out):
                    raise RuntimeError(f"{name}: tiling at D {d} failed")
                ce._TILING[(ce.KERNEL_WIDE_FWD, bf16, d, dev)] = tuple(out)
                got = ce.ce_fwd(h, W, b, labels)
                want = ce.ce_fwd_reference(h, W, b, labels)
                err = cs.max_err(got, want)
                ms = cs.device_ms(lambda: ce.ce_fwd(h, W, b, labels),
                                  args.iters)
                print(f"[k3] {name:10s} D={d} device_ms {ms!r}; blocks an "
                      f"SM {out[2]}; max err {err:.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
