"""Locality-sensitive hashing over embedding-dimension columns (paper §3.2).

A column ``q ∈ R^l`` (``l`` = Q-block row count) is projected to ``N' = 16``
dimensions, sign-binarised, and the 16-bit word is decoded with the inverse
Gray code so that codewords differing in one low-order bit map to adjacent
integers.  Sorting the hashes (stably) yields the grouping permutation.

Codes stay below 2**16, so int64 arithmetic reproduces the reference's
uint32 prefix-XOR decode exactly.
"""
from __future__ import annotations

import torch

N_PRIME = 16


def make_projection(generator: torch.Generator, block_len: int,
                    n_prime: int = N_PRIME) -> torch.Tensor:
    """Random signed projection ``R ∈ {±1}^{n_prime × block_len}`` (f32),
    drawn once ahead of time from ``generator`` and shared by every layer."""
    bits = torch.rand((n_prime, block_len), generator=generator,
                      device=generator.device) < 0.5
    return torch.where(bits, 1.0, -1.0).to(torch.float32)


def inverse_gray(codes: torch.Tensor) -> torch.Tensor:
    """Decode a Gray codeword to its rank (prefix XOR over 32 bits)."""
    codes = codes.to(torch.int64)
    for shift in (1, 2, 4, 8, 16):
        codes = codes ^ (codes >> shift)
    return codes


def _morton16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Interleave two 8-bit integers into a 16-bit Z-order code."""

    def spread(x):
        x = x.to(torch.int64)
        x = (x | (x << 4)) & 0x0F0F
        x = (x | (x << 2)) & 0x3333
        x = (x | (x << 1)) & 0x5555
        return x

    return (spread(a) << 1) | spread(b)


def hash_columns(block: torch.Tensor, proj: torch.Tensor,
                 method: str = "sign_gray") -> torch.Tensor:
    """Hash each embedding-dim column of ``block`` ``(..., l, d)`` under
    ``proj`` ``(n_prime, l)`` → ``(..., d)`` int64.

    ``"sign_gray"`` is the paper's scheme (sign bits decoded as a Gray
    rank); ``"proj_morton"`` quantises the first two projections to 8 bits
    each and Z-order interleaves them.
    """
    projected = torch.einsum("pl,...ld->...pd", proj.to(torch.float32),
                             block.to(torch.float32))
    if method == "sign_gray":
        n_prime = proj.shape[0]
        bits = (projected > 0).to(torch.int64)
        weights = 2 ** torch.arange(n_prime - 1, -1, -1, dtype=torch.int64,
                                    device=block.device)
        codes = (bits * weights[:, None]).sum(dim=-2)
        return inverse_gray(codes)
    if method == "proj_morton":
        p = projected[..., :2, :]
        lo = p.amin(dim=-1, keepdim=True)
        hi = p.amax(dim=-1, keepdim=True)
        u = (p - lo) / torch.clamp(hi - lo, min=1e-9)
        q8 = torch.clamp((u * 255.0).to(torch.int32), 0, 255)
        return _morton16(q8[..., 0, :], q8[..., 1, :])
    raise ValueError(f"unknown LSH method {method!r}")


def permutation_from_hashes(hashes: torch.Tensor) -> torch.Tensor:
    """Stable argsort of hashes → grouping permutation over d (paper Fig. 5)."""
    return torch.argsort(hashes, dim=-1, stable=True)


def lsh_permutation(block: torch.Tensor, proj: torch.Tensor,
                    method: str = "sign_gray") -> torch.Tensor:
    """Convenience: block ``(..., l, d)`` → permutation ``(..., d)``."""
    return permutation_from_hashes(hash_columns(block, proj, method))
