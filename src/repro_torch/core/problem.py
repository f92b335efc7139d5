"""Problem specification for joint probabilistic selection + power allocation.

The system model of Section II of the paper, on torch tensors:

* OFDMA uplink rate  r_ik(P) = B_i log2(1 + P g_ik / (d_i^2 (sigma^2 + I_ik)))
* transmission time  T_ik(P) = S_i / r_ik(P)                          (eq. 1)
* computation energy E^c_i   = kappa * C_i * |D_i| * gamma_i^2        (eq. 5)
* upload energy      E^u_ik  = P_ik * T_ik(P_ik)

Per-device quantities are float32 tensors of shape ``[N]``, or ``[N, K]``
with per-round fading.  The broadcasting contract is the reference's
(``repro.core.problem``): every method taking ``a`` or ``power`` accepts
either rank and broadcasts 1-d operands with ``x[:, None]`` against the
highest rank present, never the reverse.

``log2`` is evaluated as ``log(x) / ln 2`` in float32, which is how the
reference evaluates it, and every quotient with a python float goes
through :func:`div`, so the two agree to the last bit wherever their
``log`` and ``expm1`` do.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

LN2 = float(np.log(2.0))

# Uncompressed payload of the paper's model: 199_210 fp32 parameters.
GRAD_SIZE_BITS_FP32 = 199_210 * 32.0

_TENSOR_FIELDS = ("distance_m", "bandwidth_hz", "energy_budget_j",
                  "dataset_size", "cycles_per_sample", "cpu_hz", "weights",
                  "fading", "interference", "bits")

# neutral per-device fills: a zero energy budget makes every solver
# self-deselect the slot (a* = 0, P* = 0) while distance and bandwidth 1
# keep every closed form finite, and weight 0 removes it from the
# objective.  ``core.batch`` pads ragged fleets with them.
NEUTRAL_FILLS = dict(distance_m=1.0, bandwidth_hz=1.0, energy_budget_j=0.0,
                     dataset_size=1.0, cycles_per_sample=1.0, cpu_hz=1.0,
                     weights=0.0)
_FADING_FILL = 1.0
_INTERFERENCE_FILL = 0.0
_BITS_FILL = 32.0


def div(num, den) -> torch.Tensor:
    """The correctly rounded quotient ``num / den`` where either side may
    be a python float.

    torch evaluates ``float / tensor`` as ``reciprocal(tensor) * float``,
    and on the card ``tensor / float`` as a product with the float's
    reciprocal; both can differ from the quotient in the last bit.  The
    float becomes a 0-dim tensor on the other operand's device instead.
    """
    like = den if isinstance(den, torch.Tensor) else num
    if not isinstance(num, torch.Tensor):
        num = torch.full((), num, dtype=like.dtype, device=like.device)
    if not isinstance(den, torch.Tensor):
        den = torch.full((), den, dtype=like.dtype, device=like.device)
    return torch.div(num, den)


def log2(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log(x) / ln 2``: the reference's evaluation of log2."""
    return div(torch.log(x), LN2)


@dataclasses.dataclass(frozen=True)
class WirelessFLProblem:
    """Static description of the joint selection/power problem (7).

    Tensor fields have shape ``[N]`` unless noted; python floats are the
    shared constants.  ``fading`` (``[N, K]``, or ``[N]`` for a
    round-invariant draw), ``interference`` and ``bits`` are optional,
    with the reference's semantics: ``None`` means unit gain, a single
    cell and the fp32 payload.
    """

    distance_m: torch.Tensor          # d_i, metres to the server
    bandwidth_hz: torch.Tensor        # B_i
    energy_budget_j: torch.Tensor     # E_i^max, per-round energy budget
    dataset_size: torch.Tensor        # |D_i|
    cycles_per_sample: torch.Tensor   # C_i
    cpu_hz: torch.Tensor              # gamma_i
    weights: torch.Tensor             # w_i, objective weights (sum to 1)
    fading: Optional[torch.Tensor] = None
    interference: Optional[torch.Tensor] = None
    bits: Optional[torch.Tensor] = None

    grad_size_bits: float = GRAD_SIZE_BITS_FP32
    noise_power: float = 1e-12
    p_max: float = 1.0
    tau_th: float = 0.08
    kappa: float = 1e-28
    n_rounds: int = 1

    # ---------------------------------------------------------------- api
    @property
    def n_devices(self) -> int:
        return int(self.distance_m.shape[0])

    @property
    def device(self) -> torch.device:
        return self.distance_m.device

    def to(self, device) -> "WirelessFLProblem":
        """The same problem with every tensor on ``device``."""
        dev = torch.device(device)
        moved = {f: getattr(self, f).to(dev) for f in _TENSOR_FIELDS
                 if getattr(self, f) is not None}
        return dataclasses.replace(self, **moved)

    def path_gain(self) -> torch.Tensor:
        """g_ik / (d_i^2 (sigma^2 + I_ik)): SINR per transmitted watt."""
        g = self.fading
        d2s = torch.square(self.distance_m) * self.noise_power
        base = div(1.0, d2s)
        if self.interference is None:
            if g is None:
                return base
            # a zero/NaN gain gates the device out (P^min = inf)
            return torch.where(g > 0, g * _bcast_like(base, g.ndim), 0.0)
        d2 = torch.square(self.distance_m)
        rank = 2 if ((g is not None and g.ndim == 2)
                     or self.interference.ndim == 2) else 1
        iv = _bcast_like(self.interference, rank)
        denom = _bcast_like(d2s, rank) + _bcast_like(d2, rank) * iv
        pg = div(1.0, denom)
        if g is None:
            return pg
        gv = _bcast_like(g, pg.ndim)
        return torch.where(gv > 0, gv * pg, 0.0)

    def _pg(self, like: torch.Tensor) -> torch.Tensor:
        """path_gain broadcast to the rank of ``like`` ([N] or [N, K])."""
        pg = self.path_gain()
        if like.ndim > pg.ndim:
            pg = pg[:, None]
        return pg

    def rate(self, power: torch.Tensor) -> torch.Tensor:
        """Achievable uplink rate r_ik(P) in bits/s."""
        pg = self._pg(power)
        p = power if power.ndim >= pg.ndim else power[:, None]
        bw = self.bandwidth_hz
        if max(p.ndim, pg.ndim) > bw.ndim:
            bw = bw[:, None]
        return bw * log2(1.0 + p * pg)

    def payload_bits(self, rank: int = 1):
        """Effective uplink payload S_i = S b_i / 32: the python float
        ``grad_size_bits`` without a ``bits`` leaf, else a tensor at
        ``rank``."""
        if self.bits is None:
            return self.grad_size_bits
        return self.grad_size_bits * _bcast_like(self.bits, rank) / 32.0

    def tx_time(self, power: torch.Tensor) -> torch.Tensor:
        """Transmission time T_ik(P) = S_i / r_ik(P)  (eq. 1)."""
        r = torch.clamp(self.rate(power), min=1e-30)
        rank = r.ndim if self.bits is None else max(r.ndim, self.bits.ndim)
        return div(self.payload_bits(rank), _bcast_like(r, rank))

    def compute_energy(self) -> torch.Tensor:
        """E^c_i = kappa C_i |D_i| gamma_i^2  (eq. 5)."""
        return (self.kappa * self.cycles_per_sample * self.dataset_size
                * torch.square(self.cpu_hz))

    def upload_energy(self, power: torch.Tensor) -> torch.Tensor:
        """E^u_ik = P T_ik(P)."""
        t = self.tx_time(power)
        p = power if power.ndim >= t.ndim else power[:, None]
        return p * t

    def p_min(self, a: torch.Tensor) -> torch.Tensor:
        """Minimum power meeting the time constraint (7c) at probability a:
        P^min_ik = (2^{a S / (B_i tau)} - 1) / path_gain, the exponent
        clamped at 120 and a zero gain gated to ``inf``."""
        pg = self._pg(a)
        rank = max(a.ndim, pg.ndim)
        if self.bits is not None:
            rank = max(rank, self.bits.ndim)
        av = _bcast_like(a, rank)
        pgv = _bcast_like(pg, rank)
        bw = _bcast_like(self.bandwidth_hz, rank)
        exponent = av * self.payload_bits(rank) / (bw * self.tau_th)
        exponent = torch.clamp(exponent, max=120.0)
        num = torch.expm1(exponent * LN2)
        return torch.where(pgv > 0, num / torch.where(pgv > 0, pgv, 1.0),
                           torch.inf)

    def objective(self, a: torch.Tensor) -> torch.Tensor:
        """Weighted sum of selection probabilities (7a) for one round."""
        w = self.weights if a.ndim == 1 else self.weights[:, None]
        return torch.sum(a * w)

    def constraints_satisfied(self, a: torch.Tensor, power: torch.Tensor,
                              rtol: float = 1e-4) -> torch.Tensor:
        """Boolean feasibility of (7b)-(7e) per element (with tolerance)."""
        t = self.tx_time(power)
        rank = max(a.ndim, power.ndim, t.ndim)
        av = _bcast_like(a, rank)
        pv = _bcast_like(power, rank)
        tv = _bcast_like(t, rank)
        eu = pv * tv
        energy_ok = av * (eu + _bcast_like(self.compute_energy(), rank)) \
            <= _bcast_like(self.energy_budget_j, rank) * (1 + rtol) + 1e-12
        time_ok = av * tv <= self.tau_th * (1 + rtol)
        p_ok = (pv >= -1e-12) & (pv <= self.p_max * (1 + rtol))
        a_ok = (av >= -1e-12) & (av <= 1 + rtol)
        return energy_ok & time_ok & p_ok & a_ok


def _bcast_like(x: torch.Tensor, rank: int) -> torch.Tensor:
    """Broadcast a per-device ``[N]`` vector to ``[N, 1]`` when the
    surrounding expression is per-round ``[N, K]`` (rank 2)."""
    return x if x.ndim >= rank else x[:, None]


def _f32(x, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.float32)).to(device)


def sample_problem(rng: np.random.Generator | int,
                   n_devices: int = 100,
                   *,
                   area_m: float = 1000.0,
                   total_bandwidth_hz: float = 10e6,
                   tau_th: float = 0.08,
                   p_max: float = 1.0,
                   grad_size_bits: float = GRAD_SIZE_BITS_FP32,
                   n_rounds: int = 1,
                   energy_budget_range: tuple[float, float] = (1e-3, 100.0),
                   dataset_total: int = 60_000,
                   dirichlet_sizes: Optional[np.ndarray] = None,
                   with_fading: bool = False,
                   device=None) -> WirelessFLProblem:
    """Draw a random scenario matching the paper's simulation setup
    (Sec. V-A), with the reference's numpy draws in the same order, so
    the same seed gives the same problem bit for bit."""
    dev = resolve_device(device)
    rng = np.random.default_rng(rng) if not isinstance(rng, np.random.Generator) else rng
    xy = rng.uniform(0.0, area_m, size=(n_devices, 2))
    centre = np.array([area_m / 2, area_m / 2])
    d = np.maximum(np.linalg.norm(xy - centre, axis=1), 1.0)

    if dirichlet_sizes is not None:
        sizes = np.asarray(dirichlet_sizes, dtype=np.float64)
    else:
        props = rng.dirichlet(np.full(n_devices, 2.0))
        sizes = np.maximum(np.round(props * dataset_total), 10.0)

    lo, hi = energy_budget_range
    budgets = np.exp(rng.uniform(np.log(lo), np.log(hi), size=n_devices))

    fading = None
    if with_fading:
        fading = rng.exponential(1.0, size=(n_devices, n_rounds))

    return WirelessFLProblem(
        distance_m=_f32(d, dev),
        bandwidth_hz=_f32(np.full((n_devices,), total_bandwidth_hz / n_devices), dev),
        energy_budget_j=_f32(budgets, dev),
        dataset_size=_f32(sizes, dev),
        cycles_per_sample=_f32(rng.uniform(1e4, 5e4, n_devices), dev),
        cpu_hz=_f32(rng.uniform(0.5e9, 2e9, n_devices), dev),
        weights=_f32(sizes / sizes.sum(), dev),
        fading=None if fading is None else _f32(fading, dev),
        grad_size_bits=float(grad_size_bits),
        noise_power=1e-12,
        p_max=float(p_max),
        tau_th=float(tau_th),
        kappa=1e-28,
        n_rounds=int(n_rounds),
    )
