"""1-D layered-earth magnetotelluric analytic fields, fully vectorised.

Differentiable JAX redesign of the reference's 1-D analytic layer code
(HMCMT/src/MTFwdSolver/mt1DField.jl): surface impedance by the standard
bottom-up tanh recurrence, then top-down propagation of up/down-going wave
amplitudes, with the reference's overflow guard (zero all layers at and below
the first overflow, mt1DField.jl:76-82) expressed as a differentiable mask
inside a ``lax.scan`` instead of a ``break``.

Everything is batched: conductivity profiles have shape ``(..., n_layer)``
and all functions broadcast over leading axes (frequency, boundary column,
chain).  Time dependence is ``e^{+i omega t}`` as in the reference.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..constants import EPS0, MU0
from ..utils.host import real_dtype

# Real-exponent clamp for exp(): keeps the forward value finite so the
# overflow *mask* (not an Inf/NaN) reproduces the reference's zeroing
# behaviour, and keeps gradients clean through jnp.where.
_EXP_CLAMP = 60.0

# |Re| clamp for the safe complex tanh: tanh(20) == 1 to float32 precision,
# and sinh(2*20) stays comfortably inside float32 range.
_TANH_CLAMP = 20.0


def safe_tanh(z):
    """Overflow-safe complex tanh (a direct complex tanh produces NaN once
    exp(|Re z|) overflows float32; the skin-depth argument i*k*dz routinely
    exceeds that in the deep padding cells).

    Uses tanh(x+iy) = (sinh(2x)/2 + i*sin(2y)/2) / (sinh(x)^2 + cos(y)^2)
    with x clamped to +-20, where tanh is exactly +-1 in float32 anyway.
    """
    x = jnp.clip(jnp.real(z), -_TANH_CLAMP, _TANH_CLAMP)
    y = jnp.imag(z)
    den = jnp.sinh(x) ** 2 + jnp.cos(y) ** 2
    return lax.complex(0.5 * jnp.sinh(2.0 * x) / den, 0.5 * jnp.sin(2.0 * y) / den)


def wavenumber(omega, sigma):
    """k = sqrt(mu0*eps0*omega^2 - i*mu0*sigma*omega) with the principal
    square root (mt1DField.jl:48,66): Re k > 0, Im k < 0."""
    return jnp.sqrt(MU0 * EPS0 * omega**2 - 1j * MU0 * sigma * omega)


def surface_impedance(omega, sigma, dz):
    """Surface impedance by the bottom-up recurrence (mt1DField.jl:48-56).

    Parameters
    ----------
    omega : scalar or broadcastable array
    sigma : (..., n) layer conductivities, top first; the bottom layer is
        extended as a halfspace below the last interface.
    dz : (..., n) layer thicknesses (diff of zNode).

    Returns the complex impedance at the top of layer 0.
    """
    k = wavenumber(omega, sigma)          # (..., n)
    zp = omega * MU0 / k                  # intrinsic impedances
    # halfspace start: impedance of the bottom layer's intrinsic impedance
    z_bot = zp[..., -1]

    th = safe_tanh(1j * k * dz)           # (..., n)

    def step(z, inputs):
        zp_j, th_j = inputs
        z_new = zp_j * (z + zp_j * th_j) / (zp_j + z * th_j)
        return z_new, None

    # scan from the bottom layer upwards (reference loops j = n:-1:1 over all
    # n layers including the bottom one, with the halfspace below)
    zp_rev = jnp.moveaxis(zp, -1, 0)[::-1]
    th_rev = jnp.moveaxis(th, -1, 0)[::-1]
    z0, _ = jax.lax.scan(step, z_bot, (zp_rev, th_rev))
    return z0


def _clamped_exp(x):
    """exp of a complex number with the real part clamped to avoid Inf.

    Overflowing entries are detected separately; clamping only keeps the
    arithmetic finite so masks and gradients stay NaN-free.
    """
    re = jnp.clip(jnp.real(x), -_EXP_CLAMP, _EXP_CLAMP)
    im = jnp.imag(x)
    # split real/imag form: two real transcendentals on the clamped
    # exponent
    mag = jnp.exp(re)
    return lax.complex(mag * jnp.cos(im), mag * jnp.sin(im))


def analytic_field(omega, sigma, dz, with_h: bool = False, dtype=None):
    """Up/down-going propagation of E (and optionally H) to every interface.

    Vectorised equivalent of ``mt1DAnalyticField`` (mt1DField.jl:23-98):

    * top boundary value eTop = 1
    * up/down split from the surface impedance (mt1DField.jl:62-63)
    * layer-by-layer propagator with interface matching (mt1DField.jl:69-83)
    * overflow guard: as soon as |E| grows from one interface to the next or
      becomes NaN, that interface and everything below is zeroed
      (mt1DField.jl:76-82) — here a carried boolean mask in the scan.

    Parameters
    ----------
    sigma : (..., n) layer conductivities (top first; bottom extended as
        halfspace).
    dz : (..., n) layer thicknesses.

    Returns
    -------
    e : (..., n+1) total E at each interface (top included), e[..., 0] == 1.
    h : (..., n+1) total H if ``with_h`` (mt1DField.jl:87-93).
    """
    if dtype is not None:
        # run the whole propagation in the requested complex dtype (the
        # solve dtype: complex64 paths cast here)
        rdt = real_dtype(dtype)
        omega = jnp.asarray(omega, rdt)
        sigma = jnp.asarray(sigma, rdt)
        dz = jnp.asarray(dz, rdt)
    omega = jnp.asarray(omega)
    # omega may carry a trailing singleton standing in for the layer axis
    # (so it can broadcast against (..., n) inputs); strip it for
    # interface-level (layer-axis-free) arithmetic.
    omega_i = omega[..., 0] if (omega.ndim > 0 and omega.shape[-1] == 1) else omega
    omu0 = omega_i * MU0

    z0 = surface_impedance(omega, sigma, dz)
    k = wavenumber(omega, sigma)                       # (..., n)
    # halfspace wavenumber appended: ka has n+1 entries (mt1DField.jl:40,66)
    ka = jnp.concatenate([k, k[..., -1:]], axis=-1)    # (..., n+1)

    k_top = ka[..., 0]
    e_up0 = 0.5 * (1.0 - omu0 / (z0 * k_top))
    e_dn0 = 0.5 * (1.0 + omu0 / (z0 * k_top))

    # scan over layers: carry (e_up, e_dn, alive)
    ks = jnp.moveaxis(ka[..., :-1], -1, 0)             # (n, ...)
    ks_next = jnp.moveaxis(ka[..., 1:], -1, 0)
    dzs = jnp.moveaxis(dz, -1, 0)

    def step(carry, inputs):
        e_up, e_dn, alive = carry
        k_i, k_ip1, dz_i = inputs
        kr = k_i / k_ip1
        ph = _clamped_exp(1j * k_i * dz_i)
        phi = _clamped_exp(-1j * k_i * dz_i)
        u = ph * e_up
        d = phi * e_dn
        e_up_n = 0.5 * ((1 + kr) * u + (1 - kr) * d)
        e_dn_n = 0.5 * ((1 - kr) * u + (1 + kr) * d)
        e_prev = jnp.abs(e_up + e_dn)
        e_new = jnp.abs(e_up_n + e_dn_n)
        grew = (e_new - e_prev > 0) | jnp.isnan(e_new)
        alive_n = alive & ~grew
        zero = jnp.zeros_like(e_up_n)
        e_up_n = jnp.where(alive_n, e_up_n, zero)
        e_dn_n = jnp.where(alive_n, e_dn_n, zero)
        return (e_up_n, e_dn_n, alive_n), (e_up_n, e_dn_n)

    alive0 = jnp.ones(jnp.broadcast_shapes(e_up0.shape, dzs.shape[1:]), bool)
    e_up0 = jnp.broadcast_to(e_up0, alive0.shape)
    e_dn0 = jnp.broadcast_to(e_dn0, alive0.shape)
    (_, _, _), (ups, dns) = jax.lax.scan(step, (e_up0, e_dn0, alive0), (ks, ks_next, dzs))

    e_up = jnp.concatenate([e_up0[None], ups], axis=0)   # (n+1, ...)
    e_dn = jnp.concatenate([e_dn0[None], dns], axis=0)
    e = jnp.moveaxis(e_up + e_dn, 0, -1)                 # (..., n+1)

    if not with_h:
        return e

    ka_m = jnp.moveaxis(ka, -1, 0)
    h = jnp.moveaxis((-ka_m * e_up + ka_m * e_dn) / omu0, 0, -1)
    return e, h
