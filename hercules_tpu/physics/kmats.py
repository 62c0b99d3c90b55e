"""Element stiffness operators for the trilinear hexahedral element.

The reference carries three 8x8 blocks of 3x3 matrices K1, K2, K3 built
from closed-form integrals of shape-function gradients (compute_K,
psolve.c:5446-5573, INTEGRAL macros psolve.c:2574-2578), then evaluates
element forces either as block matvecs ("conventional",
stiffness.c:121-174) or through a factorized Walsh-spectral form
("effective": aTransposeU -> firstVector -> au, stiffness.c:245-424).

On TPU the right shape is neither: we bake *constant 24x24 matrices* and
evaluate per-element forces as one batched [E,24] x [24,24] matmul on the
MXU with per-element scalar coefficients:

    f = -(c1 * U @ M1^T + c2 * U @ M2^T)        (elastic + Rayleigh)
    f -= mu_f * Ds @ KMU^T + kp_f * Dk @ KKAPPA^T   (BKT viscoelastic)

where M1 = K1+K3, M2 = K2 flattened node-major, and KMU/KKAPPA are the
BKT damping operators extracted from the reference's spectral pipeline
(damping.c:228-416, firstVector_mu/_kappa in stiffness.c:321-379).

All matrices are built numerically at setup; equivalence of the spectral
and integral forms is unit-tested.
"""

from __future__ import annotations

import numpy as np

# corner sign table xi[axis][node]: node w -> (-1)^(1 - bit) per axis
# (psolve.c:5451-5453); node w bit0 = x, bit1 = y, bit2 = z
XI = np.array([
    [-1, 1, -1, 1, -1, 1, -1, 1],
    [-1, -1, 1, 1, -1, -1, 1, 1],
    [-1, -1, -1, -1, 1, 1, 1, 1],
], dtype=np.float64)


def _integral_1(xki, xkj, xli, xlj, xmi, xmj):
    return 4.5 * xki * xkj * (1 + xli * xlj / 3) * (1 + xmi * xmj / 3) / 8


def _integral_2(xki, xlj, xmi, xmj):
    return 4.5 * xki * xlj * (1 + xmi * xmj / 3) / 8


def build_k_matrices():
    """K1, K2, K3 as [8][8][3][3] arrays (compute_K before the K1+=K3
    merge)."""
    x = XI
    K1 = np.zeros((8, 8, 3, 3))
    K2 = np.zeros((8, 8, 3, 3))
    K3 = np.zeros((8, 8, 3, 3))
    for i in range(8):
        for j in range(8):
            for k in range(3):
                I1 = _integral_1(x[k % 3][i], x[k % 3][j],
                                 x[(k + 1) % 3][i], x[(k + 1) % 3][j],
                                 x[(k + 2) % 3][i], x[(k + 2) % 3][j])
                I2 = _integral_1(x[(k + 1) % 3][i], x[(k + 1) % 3][j],
                                 x[(k + 2) % 3][i], x[(k + 2) % 3][j],
                                 x[(k + 0) % 3][i], x[(k + 0) % 3][j])
                I3 = _integral_1(x[(k + 2) % 3][i], x[(k + 2) % 3][j],
                                 x[(k + 0) % 3][i], x[(k + 0) % 3][j],
                                 x[(k + 1) % 3][i], x[(k + 1) % 3][j])
                K3[i, j, k, k] = I1 + I2 + I3
            for k in range(3):
                for el in range(3):
                    if k == el:
                        K1[i, j, k, k] = _integral_1(
                            x[k][i], x[k][j],
                            x[(k + 1) % 3][i], x[(k + 1) % 3][j],
                            x[(k + 2) % 3][i], x[(k + 2) % 3][j])
                        K2[i, j, k, k] = _integral_1(
                            x[k][j], x[k][i],
                            x[(k + 1) % 3][j], x[(k + 1) % 3][i],
                            x[(k + 2) % 3][j], x[(k + 2) % 3][i])
                    else:
                        m = 3 - (k + el)
                        K1[i, j, k, el] = _integral_2(
                            x[k][j], x[el][i], x[m][j], x[m][i])
                        K2[i, j, k, el] = _integral_2(
                            x[k][i], x[el][j], x[m][i], x[m][j])
    return K1, K2, K3


def _flatten24(K):
    """[8][8][3][3] -> [24][24] node-major (row 3i+k, col 3j+l)."""
    return K.transpose(0, 2, 1, 3).reshape(24, 24)


def stiffness_matrices_24():
    """(M1, M2): constant 24x24 operators such that the elastic force is
    f24 = -(c1 * M1 + c2 * M2) @ u24 with the reference's c1, c2
    (the conventional method after the K1 += K3 merge)."""
    K1, K2, K3 = build_k_matrices()
    return _flatten24(K1 + K3), _flatten24(K2)


# ---------------------------------------------------------------------------
# Walsh-spectral pipeline (the "effective" factorization).  W rows are the
# Walsh functions of the corner sign vectors; atu = W @ u per component
# with the constant row zeroed (aTransposeU, stiffness.c:245-289), au is
# W^T per component (au, stiffness.c:381-424).

def _walsh_rows():
    sx, sy, sz = XI
    ones = np.ones(8)
    # spectral ordering inferred from aTransposeU: rows [const, z, y, x,
    # yz, xz, xy, xyz]
    return np.stack([ones, sz, sy, sx, sy * sz, sx * sz, sx * sy,
                     sx * sy * sz])


def _spectral_ops():
    """(AT, A): 24x24 forward/backward transforms between node-major
    displacement vectors and the component-major spectral domain used by
    firstVector* (u[0:8]=x comps as Walsh coeffs, etc.)."""
    W = _walsh_rows()
    Wz = W.copy()
    Wz[0] = 0.0  # aTransposeU zeroes the constant row
    AT = np.zeros((24, 24))
    A = np.zeros((24, 24))
    for c in range(3):
        for r in range(8):
            for n in range(8):
                # spectral index c*8+r from node-major input 3n+c
                AT[c * 8 + r, 3 * n + c] = Wz[r, n]
                # node-major output 3n+c from spectral c*8+r (full W^T)
                A[3 * n + c, c * 8 + r] = W[r, n]
    return AT, A


def _first_vector(atu, a, c, b):
    """firstVector (stiffness.c:291-319): the elastic operator in the
    spectral domain; a, c, b are the reference's first/second/third
    coefficients."""
    fv = np.zeros(24)
    x, y, z = atu[0:8], atu[8:16], atu[16:24]
    fv[0] = 0
    fv[1] = b * (atu[19] + atu[1])
    fv[2] = b * (atu[11] + atu[2])
    fv[3] = a * atu[3] + c * (atu[10] + atu[17])
    fv[4] = b * (atu[13] + atu[22] + 2. * atu[4]) / 3.
    fv[5] = ((a + b) * atu[5] + c * atu[12]) / 3.
    fv[6] = ((a + b) * atu[6] + c * atu[20]) / 3.
    fv[7] = ((a + 2. * b) * atu[7]) / 9.

    fv[8] = 0
    fv[9] = b * (atu[18] + atu[9])
    fv[10] = a * atu[10] + c * (atu[3] + atu[17])
    fv[11] = b * (atu[11] + atu[2])
    fv[12] = ((a + b) * atu[12] + c * atu[5]) / 3.
    fv[13] = b * (atu[4] + atu[22] + 2. * atu[13]) / 3.
    fv[14] = ((a + b) * atu[14] + c * atu[21]) / 3.
    fv[15] = (a + 2. * b) * atu[15] / 9.

    fv[16] = 0
    fv[17] = a * atu[17] + c * (atu[3] + atu[10])
    fv[18] = b * (atu[18] + atu[9])
    fv[19] = b * (atu[19] + atu[1])
    fv[20] = ((a + b) * atu[20] + c * atu[6]) / 3.
    fv[21] = ((a + b) * atu[21] + c * atu[14]) / 3.
    fv[22] = b * (atu[4] + atu[13] + 2. * atu[22]) / 3.
    fv[23] = (a + 2. * b) * atu[23] / 9.
    return fv


def _first_vector_mu(atu, b):
    """firstVector_mu (stiffness.c:347-379): deviatoric (shear) BKT
    operator in the spectral domain."""
    fv = np.zeros(24)
    fv[1] = b * (atu[19] + atu[1])
    fv[2] = b * (atu[11] + atu[2])
    fv[3] = b * (4. * atu[3] - 2. * (atu[10] + atu[17])) / 3.
    fv[4] = b * (atu[13] + atu[22] + 2. * atu[4]) / 3.
    fv[5] = b * (7. * atu[5] - 2. * atu[12]) / 9.
    fv[6] = b * (7. * atu[6] - 2. * atu[20]) / 9.
    fv[7] = (10. * b * atu[7]) / 27.

    fv[9] = b * (atu[18] + atu[9])
    fv[10] = b * (4. * atu[10] - 2. * (atu[3] + atu[17])) / 3.
    fv[11] = b * (atu[11] + atu[2])
    fv[12] = b * (7. * atu[12] - 2. * atu[5]) / 9.
    fv[13] = b * (atu[4] + atu[22] + 2. * atu[13]) / 3.
    fv[14] = b * (7. * atu[14] - 2. * atu[21]) / 9.
    fv[15] = (10. * b * atu[15]) / 27.

    fv[17] = b * (4. * atu[17] - 2. * (atu[3] + atu[10])) / 3.
    fv[18] = b * (atu[18] + atu[9])
    fv[19] = b * (atu[19] + atu[1])
    fv[20] = b * (7. * atu[20] - 2. * atu[6]) / 9.
    fv[21] = b * (7. * atu[21] - 2. * atu[14]) / 9.
    fv[22] = b * (atu[4] + atu[13] + 2. * atu[22]) / 3.
    fv[23] = (10. * b * atu[23]) / 27.
    return fv


def _first_vector_kappa(atu, kappa):
    """firstVector_kappa (stiffness.c:321-345): volumetric BKT operator
    in the spectral domain."""
    fv = np.zeros(24)
    fv[3] = kappa * (atu[3] + atu[10] + atu[17])
    fv[5] = kappa * (atu[5] + atu[12]) / 3.
    fv[6] = kappa * (atu[6] + atu[20]) / 3.
    fv[7] = kappa * atu[7] / 9.

    fv[10] = kappa * (atu[10] + atu[3] + atu[17])
    fv[12] = kappa * (atu[12] + atu[5]) / 3.
    fv[14] = kappa * (atu[14] + atu[21]) / 3.
    fv[15] = kappa * atu[15] / 9.

    fv[17] = kappa * (atu[17] + atu[3] + atu[10])
    fv[20] = kappa * (atu[20] + atu[6]) / 3.
    fv[21] = kappa * (atu[21] + atu[14]) / 3.
    fv[23] = kappa * atu[23] / 9.
    return fv


def _op_to_matrix(spectral_fn):
    """Lift a spectral-domain operator to a node-major 24x24 matrix:
    M = A @ F @ AT where F is the operator applied in spectral space."""
    AT, A = _spectral_ops()
    F = np.zeros((24, 24))
    eye = np.eye(24)
    for i in range(24):
        F[:, i] = spectral_fn(eye[:, i])
    return A @ F @ AT


def bkt_matrices_24():
    """(KMU, KKAPPA): node-major 24x24 BKT damping operators with unit
    coefficient; the per-element force is
      f += mu_coef * KMU @ dv_shear + kappa_coef * KKAPPA @ dv_kappa
    with mu_coef = -0.5625*c1 and kappa_coef = -0.5625*(c2 + 2/3*c1)
    (damping.c:376-377)."""
    kmu = _op_to_matrix(lambda atu: _first_vector_mu(atu, 1.0))
    kkappa = _op_to_matrix(lambda atu: _first_vector_kappa(atu, 1.0))
    return kmu, kkappa
