"""Shared kernel utilities: padding, the score sentinel, device choice, and
the build and loader of the hand-written Hopper kernels in ``csrc/``.

The kernels are CUDA C++ for ``sm_90a`` with a plain C interface. They are
compiled with ``nvcc`` on first use (one compiler process per source, all
started together, then one link) into ``build/kernels/`` at the root of the
checkout, keyed by a hash of the sources, and bound with ``ctypes``. Nothing
is compiled or loaded when a module is imported, so the CPU tests import
every module without a CUDA toolchain.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

NEG_INF = float(-3.0e38)

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

# rows (or score columns) one block of the scan and top-k kernels sorts;
# must equal MINT_CHUNK in csrc/select.cuh (checked when the library loads)
CHUNK = 1024


def pad_to(x: torch.Tensor, axis: int, multiple: int, value=0.0) -> torch.Tensor:
    size = x.shape[axis]
    rem = (-size) % multiple
    if rem == 0:
        return x
    pad_shape = list(x.shape)
    pad_shape[axis] = rem
    fill = torch.full(pad_shape, value, dtype=x.dtype, device=x.device)
    return torch.cat([x, fill], dim=axis)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def neg_inf_for(dtype) -> float:
    """Masking/padding sentinel pinned per score dtype: the most negative
    FINITE value exactly representable in ``dtype`` that still lands at or
    below ``NEG_INF`` after the cast to f32 — or -inf when the dtype has no
    finite value that low (f16 tops out at -65504, far ABOVE the f32
    sentinel, so a finite f16 sentinel would beat empty result slots and
    let a masked row surface as a real candidate)."""
    if dtype == torch.float32:
        return NEG_INF
    lo = float(torch.finfo(dtype).min)
    return lo if lo <= NEG_INF else float("-inf")


def strict_fp32() -> None:
    """Turn TF32 off for float32 products and convolutions. TF32 keeps about
    three decimal digits, which moves scores enough to reorder top-k ids
    against the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the CUDA card, and
    raises when there is none — nothing drops to the CPU unasked. Tests
    pass ``device="cpu"`` to run the plain versions."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the host")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        strict_fp32()
    return device


# ---- build and load --------------------------------------------------------


def kernel_sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def sources_hash() -> str:
    h = hashlib.sha256()
    for p in kernel_sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libmint_kernels_{sources_hash()}.so"


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin")
    return nvcc


def build_commands(nvcc: str, out_dir: Path, lib: Path) -> tuple[list, list]:
    """(one compile command per .cu source, the link command)."""
    compiles, objects = [], []
    for src in kernel_sources():
        if src.suffix != ".cu":
            continue
        obj = out_dir / (src.stem + ".o")
        objects.append(str(obj))
        compiles.append([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)])
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            *objects, "-o", str(lib), "-lcudart"]
    return compiles, link


def build_library() -> Path:
    """Compile ``csrc/*.cu`` into the hashed shared library unless it is
    already built. All compiler processes start together; a failed compile
    or link raises with the compiler's output."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp = Path(tmp)
        staged = tmp / lib.name
        compiles, link = build_commands(nvcc, tmp, staged)
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in compiles]
        failures = []
        for cmd, proc in zip(compiles, procs):
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{' '.join(cmd)}\n{out}")
        if failures:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"kernel link failed:\n{' '.join(link)}\n{res.stdout}")
        os.replace(staged, lib)  # atomic: a reader never sees half a library
    return lib


_P = ctypes.c_void_p
_I = ctypes.c_int

# C entry points: name -> argument types (every one returns a cudaError_t)
_SIGNATURES = {
    "mint_batched_scores": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "mint_topk_scores": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "mint_streaming_scan": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                            _P, _P, _P, _P, _P],
}


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mint_error_string.argtypes = [ctypes.c_int]
    lib.mint_error_string.restype = ctypes.c_char_p
    lib.mint_chunk_rows.argtypes = []
    lib.mint_chunk_rows.restype = ctypes.c_int
    if lib.mint_chunk_rows() != CHUNK:
        raise RuntimeError(f"csrc chunk size {lib.mint_chunk_rows()} != {CHUNK}")
    return lib


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error after its launches
    (a refused launch never runs, and a later synchronize would not say)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}: "
                           f"{lib.mint_error_string(err).decode()}")


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
METRIC_CODES = {"dot": 0, "cosine": 1, "l2": 2}


def check_cuda_operand(name: str, t: torch.Tensor, device: torch.device,
                       dtypes=tuple(DTYPE_CODES)) -> None:
    """Device, dtype and contiguity checks before a pointer reaches C."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def merge_scratch_elems(B: int, P: int, Lc: int, k: int) -> int:
    """u64 elements each of the two ping-pong buffers needs: the phase-one
    partial lists (B, P, Lc) and every pairwise merge round after it."""
    most = B * P * Lc
    L = Lc
    while P > 1:
        P, L = (P + 1) // 2, min(k, 2 * L)
        most = max(most, B * P * L)
    return most
