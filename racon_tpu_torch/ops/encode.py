"""Base-space encoding for the device kernels.

Sequences live as ASCII bytes on the host; the kernels work on int8 codes:
A=0, C=1, G=2, T=3, everything else (N, IUPAC) = 4. Code 4 compares equal
to itself, matching the reference's char-equality semantics ('N' vs 'N'
is a match for spoa/edlib). PAD=5 never matches anything, including
itself.

A batch whose bases are all ACGT also ships 2-bit packed (`pack_2bit`,
four bases a byte): a quarter of the host-to-device bytes. The kernels
unpack in their own operand loads and restore PAD beyond each length;
`unpack_2bit` is the plain inverse their plain versions use.
"""

from __future__ import annotations

import numpy as np
import torch

A, C, G, T, N, PAD = 0, 1, 2, 3, 4, 5

_LUT = np.full(256, N, dtype=np.int8)
for i, b in enumerate(b"ACGT"):
    _LUT[b] = i


def encode_padded(seqs: list[bytes], length: int) -> tuple[np.ndarray, np.ndarray]:
    """Encode a batch of sequences into a [len(seqs), length] int8 array
    padded with PAD; returns (codes, lengths)."""
    out = np.full((len(seqs), length), PAD, dtype=np.int8)
    lens = np.empty(len(seqs), dtype=np.int32)
    for i, s in enumerate(seqs):
        n = min(len(s), length)
        out[i, :n] = _LUT[np.frombuffer(s, dtype=np.uint8)[:n]]
        lens[i] = n
    return out, lens


def packable(codes: np.ndarray, lens: np.ndarray) -> bool:
    """True when a [B, L] code batch is exactly reconstructible from its
    2-bit packing: every in-length code is ACGT (< 4) and every
    beyond-length position is PAD. N/IUPAC operands (code 4) stay int8:
    2 bits cannot carry them."""
    pos = np.arange(codes.shape[1])[None, :]
    valid = pos < np.asarray(lens).reshape(-1, 1)
    return bool(np.all(np.where(valid, codes < 4, codes == PAD)))


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """[B, L] int8 codes -> [B, ceil(L/4)] uint8, 4 bases per byte
    (base i in bits 2i..2i+1). Codes >= 4 pack as their low 2 bits:
    callers gate with `packable` (PAD positions are restored from the
    lengths on unpack, so their packed value is immaterial)."""
    b, l = codes.shape
    l4 = (l + 3) // 4 * 4
    arr = np.zeros((b, l4), dtype=np.uint8)
    arr[:, :l] = codes.astype(np.uint8) & 3
    arr = arr.reshape(b, l4 // 4, 4)
    return (arr[..., 0] | (arr[..., 1] << 2) | (arr[..., 2] << 4)
            | (arr[..., 3] << 6))


def unpack_2bit(packed: torch.Tensor, length: int, lens: torch.Tensor,
                pad: int = PAD) -> torch.Tensor:
    """The inverse of `pack_2bit` on tensors: [B, W] uint8 -> [B, length]
    int8 codes, positions at or beyond each row's `lens` restored to
    `pad`: the int8 operand the batch would have shipped."""
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=packed.device)
    v = (packed[:, :, None] >> shifts) & 3                  # [B, W, 4]
    v = v.reshape(packed.shape[0], -1)[:, :length].to(torch.int8)
    pos = torch.arange(length, device=packed.device)[None, :]
    return torch.where(pos < lens.to(torch.int64)[:, None], v,
                       torch.tensor(pad, dtype=torch.int8,
                                    device=packed.device))
