"""Hamming distances between packed 1-bit sign sketches.

The cascade's sketch tier (ops/cascade.py) and FLAT's ``SketchPrefilter``
(algo/flat.py) rank every corpus row for every query by the Hamming
distance between their sign sketches: W = ceil(D / 32) int32 words a row,
``sum_w popcount(q_w ^ x_w)``, with ``1 << 30`` on invalid rows (tombstones
and pad rows).  The JAX package computes it in XLA
(``sptag_tpu/ops/cascade.py:151`` ``_hamming``; the same loop in
``sptag_tpu/algo/flat.py:144`` and ``:166``).  PyTorch has no popcount and
no fused XOR-popcount, so on the card ``csrc/sketch_dots.cu`` computes it
(``sketch_hamming``); a CPU tensor takes the plain version, a SWAR popcount
in int64 (torch's ``>>`` on int32 is arithmetic, and bit 31 is set in about
half of all words).  The result is an exact integer: kernel and plain
version agree bit for bit.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from sptag_tpu_torch import _build

#: the invalid-row sentinel of the Hamming matrix
INVALID = 1 << 30

KERNELS = ("sketch_hamming",)
_launches = dict.fromkeys(KERNELS, 0)
_count_lock = threading.Lock()

_SIGNATURES = {
    "sptag_sketch_hamming": (ctypes.c_int, (ctypes.c_void_p,) * 4
                             + (ctypes.c_int, ctypes.c_longlong,
                                ctypes.c_int, ctypes.c_void_p)),
}


def launch_counts() -> dict:
    with _count_lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _count_lock:
        for name in KERNELS:
            _launches[name] = 0


def library() -> ctypes.CDLL:
    return _build.load("sketch_dots", _SIGNATURES)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word, as int64: SWAR on the word's unsigned
    value widened to int64."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_reference(qbits: torch.Tensor, sketches: torch.Tensor,
                      invalid: torch.Tensor) -> torch.Tensor:
    """Plain version: (Q, W) x (N, W) int32 -> (Q, N) int32, one word at a
    time so the (Q, N) running sum is the only large intermediate."""
    Q, N = qbits.shape[0], sketches.shape[0]
    ham = torch.zeros((Q, N), dtype=torch.int64, device=qbits.device)
    for w in range(sketches.shape[1]):
        ham += popcount32(qbits[:, w:w + 1] ^ sketches[None, :, w])
    ham = ham.to(torch.int32)
    return torch.where(invalid[None, :], INVALID, ham)


def hamming(qbits: torch.Tensor, sketches: torch.Tensor,
            invalid: torch.Tensor) -> torch.Tensor:
    """(Q, W) int32 query bits, (N, W) int32 sketches, (N,) bool invalid
    -> (Q, N) int32 Hamming distances, ``INVALID`` on invalid rows.  A CPU
    tensor runs the plain version; on the card the kernel (or a raise)."""
    if qbits.device.type == "cpu":
        return hamming_reference(qbits, sketches, invalid)
    for t, dt in ((qbits, torch.int32), (sketches, torch.int32),
                  (invalid, torch.bool)):
        if t.dtype != dt or not t.is_contiguous() or t.device != qbits.device:
            raise TypeError("sketch_hamming: takes contiguous int32 bits and "
                            "a bool mask on one device")
    (Q, W), N = qbits.shape, sketches.shape[0]
    if sketches.shape[1] != W or invalid.numel() != N or Q >= 2 ** 31:
        raise ValueError("sketch_hamming: shapes")
    out = torch.empty((Q, N), dtype=torch.int32, device=qbits.device)
    if Q * N == 0:
        return out
    with torch.cuda.device(qbits.device):
        rc = library().sptag_sketch_hamming(
            qbits.data_ptr(), sketches.data_ptr(), invalid.data_ptr(),
            out.data_ptr(), Q, N, W, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sketch_hamming: CUDA launch failed ({rc})")
    with _count_lock:
        _launches["sketch_hamming"] += 1
    return out
