"""MIMO RX equalization ("predecoding") and TX precoding + layer mapping.

Capability parity with lib/src/phy/mimo/precoding.c and layermap.c:
single-port MRC/MMSE (precoding.c:63-354), 2-port SFBC diversity
(precoding.c:356-686), 2x2 spatial multiplexing ZF/MMSE with codebook
rotation and CSI output (precoding.c:1121-1764), TX precoding dispatchers
(precoding.c:1841-2103), layer map/demap (layermap.c:38-221).

Batched design: per-RE 2x2 solves are closed-form elementwise batches over
the whole resource grid (mat.c:55-98's ZF/MMSE formulas vectorized), not
per-RE SIMD loops.
"""

from __future__ import annotations

import enum

import jax.numpy as jnp


class MimoType(enum.Enum):
    """Transmission scheme (srslte_mimo_type_t analog)."""

    SINGLE = "single"           # TM1: 1 layer, 1 port
    DIVERSITY = "diversity"     # TM2: SFBC (2 ports)
    SPATIAL_MUX = "multiplex"   # TM3/TM4: 2x2 spatial multiplexing
    CDD = "cdd"                 # TM3 open-loop large-delay CDD


# --- RX: equalization ------------------------------------------------------


def eq_single(y, h, noise_est=0.0):
    """SISO/SIMO MRC: y[..., A, n], h[..., A, n] -> (x[..., n], csi[..., n]).

    MRC across rx antennas with MMSE scaling (precoding.c mrc/mmse 1-layer
    paths): x = sum_a conj(h_a) y_a / (sum_a |h_a|^2 + N0); csi is the
    post-combining channel gain used to weight LLRs.
    """
    num = jnp.sum(jnp.conj(h) * y, axis=-2)
    den = jnp.sum(jnp.abs(h) ** 2, axis=-2) + noise_est
    csi = den
    return num / jnp.maximum(den, 1e-20), csi


def eq_sfbc(y, h0, h1):
    """2-port SFBC (Alamouti in frequency) combining, precoding.c:356-686.

    y[..., A, n] with n even; h0/h1 [..., A, n] per-port channels, assumed
    constant over each RE pair. Returns (x[..., n], csi[..., n]).

    TX mapping (36.211 6.3.4.3): on REs (2i, 2i+1) the two ports send
    (x0, x1) as port0: (x0, x1), port1: (-x1*, x0*), scaled by 1/sqrt(2).
    """
    ye = y[..., 0::2]
    yo = y[..., 1::2]
    h0e, h1e = h0[..., 0::2], h1[..., 0::2]
    # combine across the pair and rx antennas:
    #   ye = (h0 x0 - h1 x1*)/sqrt2, yo = (h0 x1 + h1 x0*)/sqrt2
    x0 = jnp.sum(jnp.conj(h0e) * ye + h1e * jnp.conj(yo), axis=-2)
    x1 = jnp.sum(jnp.conj(h0e) * yo - h1e * jnp.conj(ye), axis=-2)
    hh = jnp.sum(jnp.abs(h0e) ** 2 + jnp.abs(h1e) ** 2, axis=-2)
    hh = jnp.maximum(hh, 1e-20)
    # undo the 1/sqrt(2) TX power split
    scale = jnp.sqrt(2.0)
    x0 = x0 / hh * scale
    x1 = x1 / hh * scale
    out = jnp.stack([x0, x1], axis=-1).reshape(*x0.shape[:-1], -1)
    csi = jnp.repeat(hh, 2, axis=-1)
    return out, csi


def eq_mux_2x2_components(y0, y1, h00, h01, h10, h11, noise_est=0.0):
    """Component form of the 2x2 MMSE solve: no stacked arrays in or out
    (the grid-domain fused receiver feeds grid-shaped slices directly).
    Returns (x0, x1, csi0, csi1)."""
    a = jnp.abs(h00) ** 2 + jnp.abs(h10) ** 2 + noise_est   # (H^H H)_00
    d = jnp.abs(h01) ** 2 + jnp.abs(h11) ** 2 + noise_est   # (H^H H)_11
    b = jnp.conj(h00) * h01 + jnp.conj(h10) * h11           # (H^H H)_01
    det = a * d - jnp.abs(b) ** 2
    det = jnp.maximum(det, 1e-20)
    # inv = [[d, -b], [-b*, a]] / det
    hy0 = jnp.conj(h00) * y0 + jnp.conj(h10) * y1           # (H^H y)_0
    hy1 = jnp.conj(h01) * y0 + jnp.conj(h11) * y1
    x0 = (d * hy0 - b * hy1) / det
    x1 = (a * hy1 - jnp.conj(b) * hy0) / det
    # csi_i = det / opposite diagonal of inverse
    return (x0, x1, det / jnp.maximum(d, 1e-20),
            det / jnp.maximum(a, 1e-20))


def eq_mux_2x2(y, h, noise_est=0.0, mmse: bool = True):
    """2x2 spatial multiplexing ZF/MMSE (precoding.c:1121-1764, mat.c:63-98).

    y[..., 2, n] rx symbols, h[..., 2rx, 2tx, n] channel ->
    (x[..., 2, n] layer symbols, csi[..., 2, n]).

    W = (H^H H + N0 I)^-1 H^H computed in closed form per RE; csi_i =
    1 / [(H^H H + N0 I)^-1]_ii, the reference's CSI output for LLR
    weighting (precoding.c MMSE with csi).
    """
    # Explicit component arithmetic: everything stays an elementwise op
    # over the RE axis, where an einsum formulation of the same math
    # lowers to tiny batched matrix products with layout transposes.
    x0, x1, csi0, csi1 = eq_mux_2x2_components(
        y[..., 0, :], y[..., 1, :], h[..., 0, 0, :], h[..., 0, 1, :],
        h[..., 1, 0, :], h[..., 1, 1, :], noise_est)
    x = jnp.stack([x0, x1], axis=-2)
    csi = jnp.stack([csi0, csi1], axis=-2)
    if not mmse:
        return x, jnp.ones_like(csi)
    return x, csi


# --- TX: layer mapping and precoding --------------------------------------


def layermap(cw_symbols, nof_layers: int, nof_codewords: int = 1):
    """Codeword(s) -> layers (layermap.c:38-221, 36.211 6.3.3).

    cw_symbols: list of [..., M_i] arrays (one per codeword). Returns
    [..., nof_layers, M_layer].
    """
    if nof_codewords == 1 and nof_layers == 1:
        return cw_symbols[0][..., None, :]
    if nof_codewords == 1 and nof_layers == 2:
        # diversity: even/odd split
        x = cw_symbols[0]
        return jnp.stack([x[..., 0::2], x[..., 1::2]], axis=-2)
    if nof_codewords == 2 and nof_layers == 2:
        return jnp.stack(cw_symbols, axis=-2)
    if nof_codewords == 1 and nof_layers == 4:
        # 4-layer diversity: x^(l)(i) = d(4i + l) (36.211 Table 6.3.3.3-1)
        x = cw_symbols[0]
        return jnp.stack([x[..., l::4] for l in range(4)], axis=-2)
    if nof_codewords == 2 and nof_layers == 3:
        # spatial multiplexing 2cw->3 layers: cw0 -> layer 0, cw1 ->
        # layers 1/2 even-odd (36.211 Table 6.3.3.2-1; layermap.c:112)
        x0, x1 = cw_symbols
        return jnp.stack([x0, x1[..., 0::2], x1[..., 1::2]], axis=-2)
    if nof_codewords == 2 and nof_layers == 4:
        # 2cw->4 layers: each codeword even-odd onto two layers
        # (layermap.c:112 layermap_multiplex)
        x0, x1 = cw_symbols
        return jnp.stack([x0[..., 0::2], x0[..., 1::2],
                          x1[..., 0::2], x1[..., 1::2]], axis=-2)
    raise NotImplementedError((nof_codewords, nof_layers))


def layerdemap(layers, nof_codewords: int = 1):
    """Layers -> codeword(s): inverse of layermap."""
    n_layers = layers.shape[-2]
    if nof_codewords == 1 and n_layers == 1:
        return [layers[..., 0, :]]
    if nof_codewords == 1 and n_layers == 2:
        x = jnp.stack([layers[..., 0, :], layers[..., 1, :]], axis=-1)
        return [x.reshape(*layers.shape[:-2], -1)]
    if nof_codewords == 2 and n_layers == 2:
        return [layers[..., 0, :], layers[..., 1, :]]
    if nof_codewords == 1 and n_layers == 4:
        x = jnp.stack([layers[..., l, :] for l in range(4)], axis=-1)
        return [x.reshape(*layers.shape[:-2], -1)]
    if nof_codewords == 2 and n_layers == 3:
        x1 = jnp.stack([layers[..., 1, :], layers[..., 2, :]], axis=-1)
        return [layers[..., 0, :], x1.reshape(*layers.shape[:-2], -1)]
    if nof_codewords == 2 and n_layers == 4:
        x0 = jnp.stack([layers[..., 0, :], layers[..., 1, :]], axis=-1)
        x1 = jnp.stack([layers[..., 2, :], layers[..., 3, :]], axis=-1)
        return [x0.reshape(*layers.shape[:-2], -1),
                x1.reshape(*layers.shape[:-2], -1)]
    raise NotImplementedError((nof_codewords, n_layers))


def precode_single(layers):
    """TM1: identity (precoding.c precoding_single)."""
    return layers


def precode_sfbc(layers):
    """TM2 SFBC: [..., 2, M] layers -> [..., 2ports, 2M] port symbols
    (36.211 6.3.4.3, precoding.c precoding_diversity)."""
    x0 = layers[..., 0, :]
    x1 = layers[..., 1, :]
    s = 1.0 / jnp.sqrt(2.0)
    p0 = jnp.stack([x0, x1], axis=-1).reshape(*x0.shape[:-1], -1) * s
    p1 = jnp.stack([-jnp.conj(x1), jnp.conj(x0)], axis=-1).reshape(
        *x0.shape[:-1], -1) * s
    return jnp.stack([p0, p1], axis=-2)


def precode_sfbc_fstd(layers):
    """4-port SFBC-FSTD (36.211 6.3.4.3; precoding.c:1863-1889): groups
    of 4 REs carry the Alamouti pair (x0, x1) on ports {0, 2} over REs
    (4i, 4i+1) and (x2, x3) on ports {1, 3} over REs (4i+2, 4i+3).

    layers [..., 4, M] -> ports [..., 4, 4M]."""
    x0 = layers[..., 0, :]
    x1 = layers[..., 1, :]
    x2 = layers[..., 2, :]
    x3 = layers[..., 3, :]
    z = jnp.zeros_like(x0)
    s = 1.0 / jnp.sqrt(2.0)

    def inter4(a, b, c, d):
        return jnp.stack([a, b, c, d], axis=-1).reshape(
            *a.shape[:-1], -1)

    p0 = inter4(x0, x1, z, z) * s
    p1 = inter4(z, z, x2, x3) * s
    p2 = inter4(-jnp.conj(x1), jnp.conj(x0), z, z) * s
    p3 = inter4(z, z, -jnp.conj(x3), jnp.conj(x2)) * s
    return jnp.stack([p0, p1, p2, p3], axis=-2)


def eq_sfbc_fstd(y, h0, h1, h2, h3):
    """4-port SFBC-FSTD combining (predecoding_diversity 4-port,
    precoding.c:356-686): Alamouti-combine REs (4i, 4i+1) with ports
    (0, 2) and REs (4i+2, 4i+3) with ports (1, 3).

    y [..., A, n] (n % 4 == 0); h0..h3 [..., A, n] per-port channels.
    Returns (x [..., n], csi [..., n])."""
    n = y.shape[-1]
    assert n % 4 == 0

    def pick(a, lo):
        q = a.reshape(*a.shape[:-1], n // 4, 4)
        return q[..., lo : lo + 2].reshape(*a.shape[:-1], n // 2)

    x_a, csi_a = eq_sfbc(pick(y, 0), pick(h0, 0), pick(h2, 0))
    x_b, csi_b = eq_sfbc(pick(y, 2), pick(h1, 2), pick(h3, 2))

    def weave(a, b):
        qa = a.reshape(*a.shape[:-1], n // 4, 2)
        qb = b.reshape(*b.shape[:-1], n // 4, 2)
        return jnp.concatenate([qa, qb], axis=-1).reshape(*a.shape[:-1], n)

    return weave(x_a, x_b), weave(csi_a, csi_b)


#: 36.211 Table 6.3.4.2.3-1 codebook for 2 antenna ports, 2 layers (TM4).
def codebook_2x2(pmi: int):
    import numpy as np

    if pmi == 0:
        w = np.array([[1, 0], [0, 1]], np.complex64)
    elif pmi == 1:
        w = np.array([[1, 1], [1, -1]], np.complex64) / np.sqrt(2)
    elif pmi == 2:
        w = np.array([[1, 1], [1j, -1j]], np.complex64) / np.sqrt(2)
    else:
        raise ValueError(pmi)
    return w / np.sqrt(2)


def precode_mux_2x2(layers, pmi: int = 0):
    """TM4 closed-loop 2-layer precoding: x_ports = W @ x_layers.
    Expanded per matrix entry (elementwise over the RE axis)."""
    w = codebook_2x2(pmi)
    return jnp.stack(
        [w[p, 0] * layers[..., 0, :] + w[p, 1] * layers[..., 1, :]
         for p in range(2)], axis=-2)


def effective_channel_mux(h, pmi: int = 0):
    """Fold the TM4 precoder into the estimated per-port channel:
    h[..., rx, port, n] -> h_eff[..., rx, layer, n] = H W.
    Expanded per matrix entry (elementwise, where the einsum form
    lowers to tiny batched matrix products)."""
    w = codebook_2x2(pmi)
    return jnp.stack(
        [w[0, l] * h[..., 0, :] + w[1, l] * h[..., 1, :]
         for l in range(2)], axis=-2)


# --- PMI selection and channel condition (precoding.c:2148-2923) -----------


def pmi_select_2layer(h, noise_est=1e-4):
    """SINR-maximizing PMI for TM4 2-layer over the 2x2 codebook.

    h [..., rx, port, n] -> (pmi [...], sinr [..., 3]) — evaluates the
    post-MMSE SINR for each codebook entry averaged over the REs
    (srslte_precoding_pmi_select, precoding.c:2148-2886).
    """
    import numpy as np

    sinrs = []
    for pmi in range(3):
        h_eff = effective_channel_mux(h, pmi)
        e00 = h_eff[..., 0, 0, :]
        e01 = h_eff[..., 0, 1, :]
        e10 = h_eff[..., 1, 0, :]
        e11 = h_eff[..., 1, 1, :]
        a = jnp.abs(e00) ** 2 + jnp.abs(e10) ** 2 + noise_est
        d = jnp.abs(e01) ** 2 + jnp.abs(e11) ** 2 + noise_est
        b = jnp.conj(e00) * e01 + jnp.conj(e10) * e11
        det = jnp.maximum((a * d - jnp.abs(b) ** 2).real, 1e-20)
        # per-layer post-MMSE SINR_i = det / (noise * opposite diag) - 1
        s0 = det / (noise_est * jnp.maximum(d, 1e-20)) - 1.0
        s1 = det / (noise_est * jnp.maximum(a, 1e-20)) - 1.0
        sinrs.append(jnp.mean(jnp.log1p(jnp.maximum(s0, 0))
                              + jnp.log1p(jnp.maximum(s1, 0)), axis=-1))
    stack = jnp.stack(sinrs, axis=-1)
    return jnp.argmax(stack, axis=-1), stack


def pmi_select_1layer(h, noise_est=1e-4):
    """SINR-maximizing PMI for TM4 single layer over the 4-entry rank-1
    codebook (36.211 Table 6.3.4.2.3-2): w = [1, v]/sqrt(2),
    v in {1, -1, j, -j}."""
    vs = (1.0, -1.0, 1j, -1j)
    sinrs = []
    for v in vs:
        heff = (h[..., 0, :] + v * h[..., 1, :]) / jnp.sqrt(2.0)
        g = jnp.sum(jnp.abs(heff) ** 2, axis=-2)  # over rx antennas
        sinrs.append(jnp.mean(g, axis=-1) / noise_est)
    stack = jnp.stack(sinrs, axis=-1)
    return jnp.argmax(stack, axis=-1), stack


def condition_number_db(h):
    """Average 2x2 channel condition number in dB
    (srslte_precoding_cn, precoding.c:2889-2923; mat.c:107-127)."""
    a = jnp.abs(h[..., 0, 0, :]) ** 2 + jnp.abs(h[..., 1, 0, :]) ** 2
    d = jnp.abs(h[..., 0, 1, :]) ** 2 + jnp.abs(h[..., 1, 1, :]) ** 2
    b = (jnp.conj(h[..., 0, 0, :]) * h[..., 0, 1, :]
         + jnp.conj(h[..., 1, 0, :]) * h[..., 1, 1, :])
    tr = a + d
    det = jnp.maximum(a * d - jnp.abs(b) ** 2, 1e-20)
    disc = jnp.sqrt(jnp.maximum(tr * tr - 4 * det, 0.0))
    lmax = (tr + disc) / 2
    lmin = jnp.maximum((tr - disc) / 2, 1e-20)
    return jnp.mean(10 * jnp.log10(lmax / lmin), axis=-1)


# --- TM3: open-loop spatial multiplexing with large-delay CDD ---------------


def _cdd_matrices():
    """W (fixed identity codebook entry), U (DFT), D(i) (per-RE cycling
    diagonal) for 2 layers (36.211 6.3.4.2.2)."""
    import numpy as np

    w = np.array([[1, 0], [0, 1]], np.complex64) / np.sqrt(2)
    u = np.array([[1, 1], [1, np.exp(-2j * np.pi / 2)]], np.complex64) / np.sqrt(2)
    return w, u


def precode_cdd_2layer(layers):
    """TM3 large-delay CDD: x_ports(i) = W D(i) U x_layers(i)
    (precoding.c precoding_cdd). layers [..., 2, n] -> ports [..., 2, n]."""
    import numpy as np

    n = layers.shape[-1]
    w, u = _cdd_matrices()
    # D(i) = diag(1, e^{-j 2 pi i / 2}) = diag(1, (-1)^i)
    sign = jnp.asarray((1.0 - 2.0 * (np.arange(n) % 2)).astype(np.float32))
    # expanded 2x2 matrix applications (elementwise over the RE axis)
    ux0 = u[0, 0] * layers[..., 0, :] + u[0, 1] * layers[..., 1, :]
    ux1 = (u[1, 0] * layers[..., 0, :]
           + u[1, 1] * layers[..., 1, :]) * sign
    return jnp.stack(
        [w[p, 0] * ux0 + w[p, 1] * ux1 for p in range(2)], axis=-2)


def effective_channel_cdd(h):
    """Fold W·D(i)·U into the per-port channel:
    h[..., rx, port, n] -> h_eff[..., rx, layer, n]."""
    import numpy as np

    n = h.shape[-1]
    w, u = _cdd_matrices()
    sign = jnp.asarray((1.0 - 2.0 * (np.arange(n) % 2)).astype(np.float32))
    # expanded (H W) D U, elementwise over the RE axis
    hw0 = w[0, 0] * h[..., 0, :] + w[1, 0] * h[..., 1, :]
    hw1 = (w[0, 1] * h[..., 0, :] + w[1, 1] * h[..., 1, :]) * sign
    return jnp.stack(
        [hw0 * u[0, m] + hw1 * u[1, m] for m in range(2)], axis=-2)
