"""Evaluation domains over BN254 Fr (port of `ezkl_tpu/plonk/domain.py`).

Three representations: coefficients; evaluations over H = <omega>,
|H| = n = 2^k; evaluations over the extended coset g*H', |H'| = n_ext.
Transforms dispatch to `ezkl_tpu_torch.kernels.ntt`.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..fieldmath import limbs
from ..fieldmath.spec import FieldSpec, bn254_fr, NWORDS
from ..kernels import ntt as nttmod


@dataclasses.dataclass(frozen=True, eq=False)
class Domain:
    spec: FieldSpec
    k: int                  # log2 domain size
    extended_k: int         # log2 extended domain size

    @property
    def n(self) -> int:
        return 1 << self.k

    @property
    def n_ext(self) -> int:
        return 1 << self.extended_k

    @property
    def omega(self) -> int:
        return nttmod.root_of_unity(self.spec, self.k)

    @property
    def omega_ext(self) -> int:
        return nttmod.root_of_unity(self.spec, self.extended_k)

    # -- transforms ---------------------------------------------------------

    def lagrange_to_coeff(self, v):
        return nttmod.intt(self.spec, v)

    def coeff_to_lagrange(self, v):
        return nttmod.ntt(self.spec, v)

    def coeff_to_extended(self, v):
        """coeffs (8, *batch, n) -> evals over the extended coset."""
        pad = torch.zeros(v.shape[:-1] + (self.n_ext - v.shape[-1],),
                          dtype=v.dtype, device=v.device)
        return nttmod.coset_ntt(self.spec, torch.cat([v, pad], dim=-1))

    def extended_to_coeff(self, v):
        return nttmod.coset_intt(self.spec, v)

    # -- host-side scalars --------------------------------------------------

    def rotate_omega(self, x: int, rotation: int) -> int:
        """x * omega^rotation (host int)."""
        p = self.spec.modulus
        w = self.omega if rotation >= 0 else pow(self.omega, -1, p)
        return (x * pow(w, abs(rotation), p)) % p

    def _periodic(self, inverse: bool, device) -> torch.Tensor:
        """Z_H(x) = x^n - 1 (or its inverse) over the extended coset, (8,
        n_ext) Montgomery: Z_H(g*w'^i) = g^n * w'^(n*i) - 1 has period
        n_ext/n, so it is tiled from host bigints."""
        def make():
            p = self.spec.modulus
            gn = pow(self.spec.generator, self.n, p)
            vals = [(gn * pow(self.omega_ext, self.n * i, p) - 1) % p
                    for i in range(self.n_ext // self.n)]
            if inverse:
                vals = [pow(v, -1, p) for v in vals]
            return limbs.to_device(np.tile(limbs.encode(self.spec, vals), (1, self.n)), device)
        return nttmod.dev_cached(("vanish", inverse, self.spec, self.k, self.extended_k,
                                  str(device)), make)

    def vanishing_on_extended(self, device=None) -> torch.Tensor:
        return self._periodic(False, limbs.device_of(device))

    def vanishing_inv_on_extended(self, device=None) -> torch.Tensor:
        """1 / Z_H over the extended coset (never zero there)."""
        return self._periodic(True, limbs.device_of(device))

    # -- polynomial evaluation at a host point ------------------------------

    def eval_coeff_at(self, coeffs, x: int) -> int:
        """Horner evaluation of an (8, n) coefficient poly (Montgomery) at
        the host scalar x, on the host (the prover evaluates in batches on
        the device instead, `prover.ProverKernels.stage_eval`)."""
        p = self.spec.modulus
        acc = 0
        for c in reversed(list(limbs.decode(self.spec, coeffs))):
            acc = (acc * x + int(c)) % p
        return acc


@functools.lru_cache(maxsize=None)
def domain(k: int, extended_k: int | None = None, gate_degree: int = 8) -> Domain:
    """Domain for 2^k rows; extended size covers gate_degree * (n-1) + 1."""
    spec = bn254_fr()
    if extended_k is None:
        need = gate_degree * ((1 << k) - 1) + 1
        extended_k = max(k, (need - 1).bit_length())
    assert extended_k <= spec.two_adicity
    return Domain(spec, k, extended_k)
