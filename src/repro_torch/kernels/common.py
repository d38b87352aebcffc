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
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

NEG_INF = float(-3.0e38)

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# -Xptxas=-v: ptxas reports each kernel's registers and spills; the build
# keeps that report beside the library (``ptxas_report``)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# streaming multiprocessors of an H100 SXM: the grid planners' default when
# no device is asked (the wrappers pass the card's own count)
H100_SMS = 132


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


def pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


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
        failures, reports = [], []
        for cmd, proc in zip(compiles, procs):
            out, _ = proc.communicate()
            reports.append(out)
            if proc.returncode != 0:
                failures.append(f"{' '.join(cmd)}\n{out}")
        if failures:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
        lib.with_suffix(".ptxas.txt").write_text("".join(reports))
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"kernel link failed:\n{' '.join(link)}\n{res.stdout}")
        os.replace(staged, lib)  # atomic: a reader never sees half a library
    return lib


def ptxas_report(names: tuple[str, ...]) -> dict[str, list[dict]]:
    """Registers and spill bytes of each compiled kernel whose mangled name
    holds one of ``names`` (listed under the first that it holds), from the
    ptxas report of the last build."""
    path = library_path().with_suffix(".ptxas.txt")
    out: dict[str, list[dict]] = {n: [] for n in names}
    entry = None
    for line in path.read_text().splitlines() if path.exists() else []:
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = dict(kernel=m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and entry is not None:
            entry.update(spill_store_bytes=int(m.group(1)), spill_load_bytes=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            entry["registers"] = int(m.group(1))
            first = next((n for n in names if n in entry["kernel"]), None)
            if first is not None:
                out[first].append(entry)
            entry = None
    return out


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C entry points: name -> argument types (every one returns a cudaError_t)
_SIGNATURES = {
    "mint_batched_scores": [_P] * 5 + [_I] * 9 + [_P],
    "mint_topk_scores": [_P] + [_I] * 11 + [_P] * 5,
    "mint_streaming_scan": [_P] * 10 + [_I] * 21 + [_P] * 5,
    "mint_flash_attention": [_P] * 5 + [_I] * 6 + [_L] * 9 + [_I, _I, _F, _F, _I]
                            + [_I] * 4 + [_P] * 4,
    "mint_flash_attention_bwd": [_P] * 10 + [_I] * 6 + [_L] * 18
                                + [_I, _I, _F, _F, _I, _P],
    "mint_flash_route": [_I, _I, _I],
    "mint_flash_bwd_route": [_I],
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


def copy_bytes(*rows: torch.Tensor) -> int:
    """Widest copy (16, 8, 4 or 2 bytes) that every row of every (n, w)
    tensor starts on."""
    for vb in (16, 8, 4, 2):
        if all(t.data_ptr() % vb == 0 and (t.shape[1] * t.element_size()) % vb == 0
               for t in rows):
            return vb
    raise ValueError("rows are not 2-byte aligned")


# lists a merge round folds (csrc/select.cu: merge_rank_kernel): each key
# does fan_in - 1 binary searches, so a wide fan-in pays only where the
# lists are few and short (a B = 1 scan: 3 launches instead of 9)
MERGE_WIDE_FAN_IN, MERGE_WIDE_MAX_KEYS = 8, 1 << 17


def merge_fan_in(B: int, P: int, Lc: int) -> int:
    """Fan-in of the merge of B x P partial lists of Lc keys."""
    return MERGE_WIDE_FAN_IN if B * P * Lc <= MERGE_WIDE_MAX_KEYS else 2


def merge_scratch_elems(B: int, P: int, Lc: int, k: int, fan_in: int) -> int:
    """u64 elements each of the two ping-pong buffers needs: the phase-one
    partial lists (B, P, Lc) and every merge round after it."""
    most = B * P * Lc
    L = Lc
    while P > 1:
        P, L = cdiv(P, fan_in), min(k, fan_in * L)
        most = max(most, B * P * L)
    return most
