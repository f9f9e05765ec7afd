"""Where the SSD scan kernel's time goes, on one NVIDIA GPU (an H100 is the
target).

    python3 chip_ssd_passes.py

Builds variants of ``src/repro_torch/kernels/csrc/ssd_scan.cu`` into
``build/ssd_variants/`` (text substitutions into a copy; the kernel source
itself is not changed), one nvcc each, all started together:

  full         the kernel as it is
  pass1        only pass 1 (chunk states)
  pass2        only pass 2 (state passing)
  pass3        only pass 3 (chunk scan)
  pass3_noCB   pass 3 without its C_i . B_j products (S stays 0): what
               computing C B^T per head, rather than once per group, costs
  pass3_noCh   pass 3 without the carried state's C_i . h_c
  hloads1      the kernel with pass 3 loading h_c one 16-byte load at a
               time a thread instead of eight
  rows64       the kernel with pass 3 blocks of 64 query rows (4 warps)
               instead of 128 (8 warps)

and times each, bf16 at mamba2-780m's widths (b 1 and 4, L 2048), with
CUDA events over a CUDA graph (chip_smoke.graph_time_ms), beside the plain
version. A variant with a pass or a product switched off computes garbage
from whatever the workspace holds: only its time means anything; ``full``,
``hloads1`` and ``rows64`` are held to the plain version (bf16, 2e-2). Prints the
card's nvidia-smi line; exits 1 without CUDA.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# name: (passes launched as a bit mask, skip C B^T, skip C h, h_c loads in
# flight, pass-3 query rows a block)
VARIANTS = {
    "full": (7, 0, 0, 8, 128),
    "pass1": (1, 0, 0, 8, 128),
    "pass2": (2, 0, 0, 8, 128),
    "pass3": (4, 0, 0, 8, 128),
    "pass3_noCB": (4, 1, 0, 8, 128),
    "pass3_noCh": (4, 0, 1, 8, 128),
    "hloads1": (7, 0, 0, 1, 128),
    "rows64": (7, 0, 0, 8, 64),
}

# (text of ssd_scan.cu, what it becomes in a variant, set by -D macros)
EDITS = [
    ("  state_k<<<", "  if (MASK & 1) state_k<<<"),
    (
        "  err = launch_dependent(state_pass_kernel<T>,",
        "  if (MASK & 2) err = launch_dependent(state_pass_kernel<T>,",
    ),
    (
        "  return launch_dependent(scan_k,",
        "  if (!(MASK & 4)) return cudaSuccess;\n  return launch_dependent(scan_k,",
    ),
    (
        "        mma16816(s[2 * np], a, b[0], b[1]);\n"
        "        mma16816(s[2 * np + 1], a, b[2], b[3]);",
        "        if (!NOCB) {\n"
        "        mma16816(s[2 * np], a, b[0], b[1]);\n"
        "        mma16816(s[2 * np + 1], a, b[2], b[3]);\n        }",
    ),
    ("  if (blk.c > 0) {\n    // h_c to bf16", "  if (!NOCH && blk.c > 0) {\n    // h_c to bf16"),
    ("constexpr int kHLoads = 8;", "constexpr int kHLoads = HLOADS;"),
    ("constexpr int kQRows = 128;", "constexpr int kQRows = QROWS;"),
]


def build_variants(build):
    src = (build.CSRC / "ssd_scan.cu").read_text()
    for old, new in EDITS:
        if src.count(old) != 1:
            raise RuntimeError(f"ssd_scan.cu no longer holds: {old!r}")
        src = src.replace(old, new)
    out_dir = ROOT / "build" / "ssd_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "ssd_variant.cu"
    path.write_text(src)
    procs = {}
    for name, (mask, no_cb, no_ch, hloads, rows) in VARIANTS.items():
        lib = out_dir / f"lib{name}.so"
        macros = [
            f"-DMASK={mask}", f"-DNOCB={no_cb}", f"-DNOCH={no_ch}", f"-DHLOADS={hloads}",
            f"-DQROWS={rows}",
        ]
        cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", *macros, "-o", str(lib), str(path)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        cdll = ctypes.CDLL(str(lib))
        cdll.ssd_scan.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        cdll.ssd_scan.restype = ctypes.c_int
        libs[name] = cdll
    return libs


def call(lib, x, dt, A, B, C, Q):
    """One scan through a variant library, as ssd_scan.ssd_scan calls the
    kernel."""
    b, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    y = torch.empty_like(x)
    h = torch.empty((b, H, P, N), dtype=x.dtype, device=x.device)
    ws = torch.empty(b * H * (L // Q) * (P * N + 1), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.ssd_scan(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
        y.data_ptr(), h.data_ptr(), ws.data_ptr(), 1, b, L, H, G, P, N, Q, stream,
    )
    if err != 0:
        raise RuntimeError(f"ssd_scan variant launch failed: cudaError {err}")
    return y, h


def main():
    if not torch.cuda.is_available():
        print("chip_ssd_passes: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import ssd_scan as SS

    smi = cs.nvidia_smi_line()
    libs = build_variants(build)
    mc = get_config("mamba2-780m")
    H, P, N, G, Q = mc.ssm_heads, mc.ssm_head_dim, mc.ssm_state, mc.ssm_ngroups, mc.ssm_chunk
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 8)
    for b in (1, 4):
        L = 2048
        per_call = (2 * b * L * H * P + 2 * b * L * G * N + b * H * P * N) * 2
        calls = [
            cs.ssd_inputs(gen, b, L, H, G, P, N, torch.bfloat16)
            for _ in range(cs.n_sets(per_call))
        ]
        yr, hr = SS.ssd_scan_ref(*calls[0], chunk=Q)
        for name in ("full", "hloads1", "rows64"):
            y, h = call(libs[name], *calls[0], Q)
            torch.testing.assert_close(y.float(), yr.float(), rtol=2e-2, atol=2e-2)
            torch.testing.assert_close(h.float(), hr.float(), rtol=2e-2, atol=2e-2)
        times = {
            name: cs.graph_time_ms([functools.partial(call, lib, *a, Q) for a in calls])
            for name, lib in libs.items()
        }
        plain = cs.graph_time_ms([functools.partial(SS.ssd_scan_ref, *a, chunk=Q) for a in calls])
        row = ", ".join(f"{name} {ms:.5f}" for name, ms in times.items())
        print(
            f"[ssd passes] bf16 b={b} L={L} H={H} G={G} P={P} N={N} Q={Q}, ms per call: "
            f"{row}; plain {plain:.5f} [{smi}]",
            flush=True,
        )
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
