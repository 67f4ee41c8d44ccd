"""Frequency positional encoding (port of the JAX package's ``ops/encoding.py``).

Output layout ``[x | sin(2^0 x) cos(2^0 x) | ... | sin(2^(L-1) x)
cos(2^(L-1) x)]``, each block the full input width — exactly the JAX
package's layout, so weights carry across with no permutation.

``sh_encode``: the real spherical harmonics of view directions, the
Instant-NGP field's direction encoding (``models/ngp_field.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def encoding_dim(dim: int, n_freqs: int) -> int:
    """Output width of :func:`freq_encode`: identity + sin/cos per band."""
    return dim + 2 * dim * n_freqs


def freq_encode(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """Encode ``x[..., d]`` to ``[..., d + 2*d*n_freqs]``."""
    if n_freqs == 0:
        return x
    freqs = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)
    scaled = x[..., None, :] * freqs[:, None]                  # [..., L, d]
    enc = torch.stack([torch.sin(scaled), torch.cos(scaled)], dim=-2)
    enc = enc.reshape(*x.shape[:-1], 2 * n_freqs * x.shape[-1])
    return torch.cat([x, enc], dim=-1)


# The degree-4 real spherical harmonics in tiny-cuda-nn's order and
# constants (its ``SphericalHarmonics`` encoding; the Condon-Shortley phase,
# index l² + l + m), each as its monomials: exponents (a, b, c) of x^a y^b z^c
# and the coefficient.
SH_C = (0.28209479177387814, 0.48860251190291987, 1.0925484305920792,
        0.94617469575755997, 0.31539156525251999, 0.54627421529603959,
        0.59004358992664352, 2.8906114426405538, 0.45704579946446572,
        0.3731763325901154, 1.4453057213202769)
_C = SH_C
SH_TERMS = (
    {(0, 0, 0): _C[0]},
    {(0, 1, 0): -_C[1]}, {(0, 0, 1): _C[1]}, {(1, 0, 0): -_C[1]},
    {(1, 1, 0): _C[2]}, {(0, 1, 1): -_C[2]},
    {(0, 0, 2): _C[3], (0, 0, 0): -_C[4]}, {(1, 0, 1): -_C[2]},
    {(2, 0, 0): _C[5], (0, 2, 0): -_C[5]},
    {(2, 1, 0): -3.0 * _C[6], (0, 3, 0): _C[6]}, {(1, 1, 1): _C[7]},
    {(0, 1, 0): _C[8], (0, 1, 2): -5.0 * _C[8]},
    {(0, 0, 3): 5.0 * _C[9], (0, 0, 1): -3.0 * _C[9]},
    {(1, 0, 0): _C[8], (1, 0, 2): -5.0 * _C[8]},
    {(2, 0, 1): _C[10], (0, 2, 1): -_C[10]},
    {(3, 0, 0): -_C[6], (1, 2, 0): 3.0 * _C[6]})


def sh_matrix(degree: int = 4) -> np.ndarray:
    """``[64, degree²]`` float64: the coefficients that take the products
    ``v_i v_j v_k`` of ``v = (1, x, y, z)`` (row ``16 i + 4 j + k``) to
    the basis functions; a monomial sits on the row of its factors in
    ascending order."""
    out = np.zeros((64, degree * degree))
    for col, terms in enumerate(SH_TERMS[:degree * degree]):
        for (a, b, c), coef in terms.items():
            i, j, k = sorted([1] * a + [2] * b + [3] * c + [0, 0, 0])[-3:]
            out[16 * i + 4 * j + k, col] = coef
    return out


@functools.lru_cache(maxsize=None)
def _sh_weights(degree: int, device: torch.device) -> torch.Tensor:
    # Formed at a layer's first (eager) call, before any capture reads it.
    return torch.tensor(sh_matrix(degree), dtype=torch.float32, device=device)


def sh_encode(dirs: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """The ``degree²`` real spherical-harmonic basis functions of unit
    directions ``dirs [..., 3]``, ``[..., degree²]`` (``degree`` 1 to 4):
    the degree-3 products of ``(1, x, y, z)`` times ``sh_matrix``, five
    launches on a card."""
    if not 1 <= degree <= 4:
        raise ValueError(f"SH degree must be 1 to 4, got {degree}")
    v = torch.cat([torch.ones_like(dirs[..., :1]), dirs], -1)
    v2 = v[..., :, None] * v[..., None, :]
    v3 = (v2[..., :, :, None] * v[..., None, None, :]).flatten(-3)
    return v3 @ _sh_weights(degree, dirs.device)
