"""Kernel K1 — bit-packed neighbour-colour counts — and its plain version.

Replaces ``mcmc_colorer_tpu/ops/pallas_bitmatmul.py:packed_nc_pallas``.
``packed_nc`` dispatches on where the tensors lie:

- CPU tensors go to ``packed_nc_reference``, the port of the JAX
  package's ``_packed_neighbor_color_counts`` (per-window unpack to 0/1
  and a product with the one-hot colour matrix);
- CUDA tensors go to the hand-written CUDA kernel ``csrc/packed_nc.cu``
  (built with nvcc for sm_90a at first use) or raise.  There is no
  fallback from the card to the plain version.

Both take one colour vector ``[K]`` or a chain axis ``[C, K]`` (an
ensemble's chains over one shared A, what JAX's ``vmap`` of the product
computes): NC is then ``[C, rows, n_col_pad]``, one launch for all
chains, and the plain version one broadcast product a window.

``launches`` counts the kernel's launches, so a run can show that its
main path went through the kernel.
"""

from __future__ import annotations

import contextlib
import ctypes
from pathlib import Path

import torch

from mcmc_colorer_tpu_torch.ops.dense_adj import PACKED_K_CHUNK

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "packed_nc.cu"
ROWS_PER_BLOCK = 8                # one warp per row
SMEM_BLOCK_BYTES = 232_448        # shared memory one block may use on Hopper
RING_BYTES = 3 * 4096 * 2         # three windows of uint16 colours
# colours travel as uint16 with 0xFFFF meaning none; a row of that many
# 16-bit counts (128 KB) fits beside the ring
N_COL_PAD_MAX = 65_408

launches = 0
_built = None


def load_kernel():
    """Build (first use only) and bind the K1 library; returns it with its
    build log and seconds (``utils/cuda_build.BuiltLibrary``)."""
    global _built
    if _built is None:
        from mcmc_colorer_tpu_torch.utils.cuda_build import build_library

        built = build_library("packed_nc", SOURCE)
        fn = built.lib.packed_nc_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = built.lib.packed_nc_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _built = built
    return _built


def _check(packed: torch.Tensor, colors: torch.Tensor, n_col_pad: int):
    if packed.dtype != torch.int32 or packed.dim() != 2:
        raise TypeError(f"packed must be 2-D int32, got {packed.dtype} {tuple(packed.shape)}")
    if colors.dtype != torch.int32 or colors.dim() not in (1, 2):
        raise TypeError(f"colors must be [K] or [C, K] int32, got {colors.dtype} "
                        f"{tuple(colors.shape)}")
    if packed.device != colors.device:
        raise ValueError(f"packed on {packed.device} but colors on {colors.device}")
    words = packed.shape[1]
    if words == 0 or words % 128:
        raise ValueError(f"words={words} not a positive multiple of 128")
    if n_col_pad <= 0 or n_col_pad % 128:
        raise ValueError(f"n_col_pad={n_col_pad} not a positive multiple of 128")
    if colors.shape[-1] > words * 32:
        raise ValueError(
            f"{colors.shape[-1]} colours for {words * 32} packed columns"
        )


def _pad_colors(colors: torch.Tensor, k_total: int) -> torch.Tensor:
    """Colours (a chain's last axis) padded with -1 (counts nowhere) to one
    per packed column."""
    if colors.shape[-1] == k_total:
        return colors
    out = torch.full((*colors.shape[:-1], k_total), -1, dtype=torch.int32,
                     device=colors.device)
    out[..., : colors.shape[-1]] = colors
    return out


def packed_nc(packed: torch.Tensor, colors: torch.Tensor, n_col_pad: int) -> torch.Tensor:
    """[rows, n_col_pad] int32: NC[i, c] = #{j : A[i, j] = 1, colors[j] = c};
    [C, rows, n_col_pad] for colours [C, K]."""
    if packed.device.type == "cpu":
        return packed_nc_reference(packed, colors, n_col_pad)
    if packed.device.type != "cuda":
        raise ValueError(f"no K1 for device {packed.device}")
    return packed_nc_cuda(packed, colors, n_col_pad)


def _colors16(colors_k: torch.Tensor, n_col_pad: int) -> torch.Tensor:
    """The kernel's colour vector: uint16 bit patterns in an int16 tensor,
    0xFFFF (counts nowhere) for colours outside [0, n_col_pad)."""
    v = torch.where((colors_k >= 0) & (colors_k < n_col_pad), colors_k, 0xFFFF)
    return torch.where(v >= 2**15, v - 2**16, v).to(torch.int16)


def packed_nc_cuda(packed: torch.Tensor, colors: torch.Tensor, n_col_pad: int, *,
                   mode: int = 0) -> torch.Tensor:
    """Launch K1 on the current stream of the tensors' card.  ``mode`` 1
    or 2 launches one of the measurement variants of ``csrc/packed_nc.cu``
    (no defined output), for measuring what holds the kernel."""
    global launches
    _check(packed, colors, n_col_pad)
    if packed.device.type != "cuda":
        raise ValueError(f"K1 needs CUDA tensors, got {packed.device}")
    if not packed.is_contiguous() or not colors.is_contiguous():
        raise ValueError("K1 needs contiguous packed and colors")
    if n_col_pad > N_COL_PAD_MAX:
        raise ValueError(
            f"n_col_pad={n_col_pad} > {N_COL_PAD_MAX}: K1 passes colours as uint16"
        )
    rows, words = packed.shape
    chains = colors.shape[0] if colors.dim() == 2 else 1
    rows_per_block = min(ROWS_PER_BLOCK, (SMEM_BLOCK_BYTES - RING_BYTES) // (n_col_pad * 2))
    colors16 = _colors16(_pad_colors(colors, words * 32), n_col_pad)
    out = torch.empty((*colors.shape[:-1], rows, n_col_pad), dtype=torch.int32,
                      device=packed.device)
    if packed.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("K1 reads and writes 16-byte vectors: align packed and out")
    if rows == 0 or chains == 0:
        return out
    lib = load_kernel().lib
    with torch.cuda.device(packed.device):
        rc = lib.packed_nc_launch(
            packed.data_ptr(), colors16.data_ptr(), out.data_ptr(),
            rows, words, n_col_pad, rows_per_block, chains, mode,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"K1 launch failed: {lib.packed_nc_error_string(rc).decode()} ({rc})"
        )
    launches += 1
    return out


@contextlib.contextmanager
def _full_float32_matmul(device: torch.device):
    """The plain version's float32 product is exact only if it runs in
    full float32; on the card TF32 is turned off for its duration."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def packed_nc_reference(packed: torch.Tensor, colors: torch.Tensor, n_col_pad: int) -> torch.Tensor:
    """Plain version of K1: per 4096-column window, unpack A to 0/1 and
    multiply by the window's one-hot colour rows (a chain axis broadcasts:
    [rows, 4096] @ [C, 4096, n_col_pad]).  The product runs in float32 and
    is cast to int32: every partial sum is an integer of at most 4096 <
    2**24, so it is exact in any order of addition."""
    _check(packed, colors, n_col_pad)
    rows, words = packed.shape
    dev = packed.device
    colors_k = _pad_colors(colors, words * 32)
    shifts = torch.arange(32, dtype=torch.int32, device=dev)[None, :, None]
    col_ids = torch.arange(n_col_pad, dtype=torch.int32, device=dev)
    out = torch.zeros((*colors.shape[:-1], rows, n_col_pad), dtype=torch.int32, device=dev)
    with _full_float32_matmul(dev):
        for k in range(words // 128):
            pk = packed[:, k * 128:(k + 1) * 128]
            # window-local column jl = bit * 128 + word (packed_bit_coords)
            bits = ((pk[:, None, :] >> shifts) & 1).to(torch.float32).reshape(
                rows, PACKED_K_CHUNK
            )
            window = colors_k[..., k * PACKED_K_CHUNK:(k + 1) * PACKED_K_CHUNK]
            onehot = (window[..., None] == col_ids).to(torch.float32)
            out += (bits @ onehot).to(torch.int32)  # in place: one accumulator
    return out
