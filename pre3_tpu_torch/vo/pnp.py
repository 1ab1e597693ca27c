"""EPnP and DLS-PnP: camera pose from 3D–2D correspondences.

Port of ``pre3_tpu/vo/pnp.py``, the reference's two PnP experiments
(Lepetit/Moreno-Noguer EPnP and Hesch/Roumeliotis DLS-PnP) as static-shape
solvers:

  1. control points = centroid + principal axes of the world points,
  2. barycentric coordinates per point,
  3. M x = 0 (M: [2N, 12]) solved by eigendecomposition of MᵀM (12×12),
  4. β for the 1- and 2-null-vector cases closed-form + Gauss–Newton
     refinement on the control-point distance constraints,
  5. Kabsch (ops/svd3) world→camera from recovered control points,
  6. best case picked by masked reprojection error.

Masked points and fixed iteration counts (the reference's ``lax.scan``s
are loops of the same length), so nothing depends on the data's shape.
Every solve is capture-safe: the square solves are the ``_ex`` forms, the
eigendecompositions ``ops/sym_eig``'s (the control points' 3×3 by
``sym3_eigh``, MᵀM's 12×12 by ``jacobi_eigh``), and the 6×3 β system,
full rank, is solved by three Householder reflections and a
back-substitution (``_lstsq_qr``): the reference's SVD-based ``lstsq``
gives the same least-squares solution there. Eigenvector bases are
unique only up to sign (and the null space up to a rotation when its
eigenvalues nearly tie), so the port agrees with the reference in r, t,
ok and err, not in the bases. One sign matters: the control points'
axes. On noisy points the linear solution depends on them, so each axis
is turned to have its largest component positive, and the pose no
longer depends on the eigensolver (the reference takes LAPACK's signs).

The reference jits ``epnp`` (its Gauss–Newton refinements unrolled,
``gn_iters`` static) and calls it from ``dls_pnp``, whose 10 iterations
are one ``lax.scan``. Here ``epnp`` is a step program
(``utils/graphs.py``) keyed by the inputs' shapes and ``gn_iters``;
``epnp_camera`` is its variant with the camera's undistortion baked in,
keyed by the camera. ``dls_pnp`` is a program keyed by the shapes alone: its ``seed``
graph runs the plain EPnP body, its ``iteration`` graph one Gauss–Newton
step on the carry, replayed ``iters`` times. Each call copies its inputs
in with one grouped copy per dtype and the packed result row out; on the
CPU the same bodies run eagerly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from pre3_tpu_torch.geometry.camera import Camera, undistort
from pre3_tpu_torch.ops.sym_eig import jacobi_eigh, sym3_eigh
from pre3_tpu_torch.utils.device import cached_constant
from pre3_tpu_torch.utils.graphs import (
    Packing, call_program, load, packed_result,
)
from pre3_tpu_torch.vo.rigid import kabsch


class PnpResult(NamedTuple):
    r: torch.Tensor  # [3, 3] world→camera rotation
    t: torch.Tensor  # [3] camera-frame translation: x_c = R x_w + t
    ok: torch.Tensor  # [] bool
    err: torch.Tensor  # [] mean masked reprojection error (normalized coords)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _pairs(device) -> tuple[torch.Tensor, torch.Tensor]:
    """(i, j) [6]: the 6 control-point pairs, i < j, on ``device``."""
    ij = cached_constant("pnp_pairs",
                         lambda: torch.triu_indices(4, 4, offset=1), device)
    return ij[0], ij[1]


def _control_points(pw: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[4, 3] control points: weighted centroid + scaled principal axes."""
    wn = w / torch.clamp(torch.sum(w), min=1e-12)
    c0 = torch.sum(pw * wn[:, None], dim=0)
    d = (pw - c0) * torch.sqrt(wn)[:, None]
    eva, eve = sym3_eigh(d.T @ d)  # ascending
    # each axis with its largest component positive: under noise the
    # linear solution depends on the control points, and an eigensolver
    # may return either sign of an axis (the card's and LAPACK's differ)
    big = torch.gather(eve, 0, torch.argmax(eve.abs(), dim=0)[None])[0]
    eve = eve * torch.where(big < 0, -1.0, 1.0)
    scale = torch.sqrt(torch.clamp(eva, min=1e-10))
    axes = eve.T * scale[:, None]  # [3, 3] rows
    return torch.cat([c0[None], c0[None] + axes], dim=0)


def _barycentric(pw: torch.Tensor, cps: torch.Tensor) -> torch.Tensor:
    """[N, 4] coordinates s.t. pw = Σ α_j c_j, Σ α_j = 1."""
    ones = torch.ones((1, 4), dtype=pw.dtype, device=pw.device)
    base = torch.cat([cps.T, ones], dim=0)  # [4, 4]
    rhs = torch.cat([pw.T, torch.ones_like(pw[:, :1]).T], dim=0)
    return torch.linalg.solve_ex(base, rhs)[0].T


def _pair_dists2(c: torch.Tensor) -> torch.Tensor:
    """[4, 3] points → [6] squared distances between every pair."""
    i, j = _pairs(c.device)
    d = c[i] - c[j]
    return torch.sum(d * d, dim=-1)


def _betas_case1(vk: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    d1 = _pair_dists2(vk[:, 0].reshape(4, 3))
    num = torch.sum(torch.sqrt(d1 * rho))
    den = torch.clamp(torch.sum(d1), min=1e-12)
    zero = torch.zeros(3, dtype=vk.dtype, device=vk.device)
    return torch.cat([(num / den)[None], zero])


def _lstsq_qr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x minimizing ‖a x − b‖ for a full-rank a [m, n], m ≥ n, b [m]: n
    Householder reflections make a upper triangular (a = QR), then R x =
    (Qᵀb)[:n] by back-substitution. Normal equations would square a's
    condition number in f32."""
    m, n = a.shape
    rows = torch.arange(m, device=a.device)
    for k in range(n):
        x = torch.where(rows >= k, a[:, k], 0.0)  # column k, from row k
        xk = x[k]
        alpha = -torch.where(xk >= 0, 1.0, -1.0) * torch.linalg.vector_norm(x)
        v = torch.where(rows == k, x - alpha, x)  # I − βvvᵀ: x → alpha·e_k
        vv = torch.sum(v * v)
        beta = torch.where(vv > 0, 2.0 / torch.where(vv > 0, vv, 1.0), 0.0)
        a = a - beta * v[:, None] * (v @ a)[None, :]
        b = b - beta * v * torch.sum(v * b)
    sol: list = [None] * n
    for i in reversed(range(n)):
        acc = b[i]
        for j in range(i + 1, n):
            acc = acc - a[i, j] * sol[j]
        sol[i] = acc / a[i, i]
    return torch.stack(sol)


def _betas_case2(vk: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    # distances are quadratic in (β1, β2): L [6, 3] @ (β1², β1β2, β2²)
    i, j = _pairs(vk.device)
    c1, c2 = vk[:, 0].reshape(4, 3), vk[:, 1].reshape(4, 3)
    d1, d2 = c1[i] - c1[j], c2[i] - c2[j]
    ll = torch.stack([torch.sum(d1 * d1, -1), 2 * torch.sum(d1 * d2, -1),
                      torch.sum(d2 * d2, -1)], dim=-1)  # [6, 3]
    sol = _lstsq_qr(ll, rho)
    b1 = torch.sqrt(torch.abs(sol[0]))
    b2 = torch.sqrt(torch.abs(sol[2])) * torch.sign(sol[1]) * torch.where(
        sol[0] >= 0, 1.0, -1.0)
    zero = torch.zeros(2, dtype=vk.dtype, device=vk.device)
    return torch.cat([torch.stack([b1, b2]), zero])


def _epnp(pw: torch.Tensor, uv_norm: torch.Tensor, valid: torch.Tensor,
          gn_iters: int) -> PnpResult:
    """EPnP's plain body (``epnp``'s program runs it; so does
    ``dls_pnp``'s seed)."""
    n = pw.shape[0]
    w = valid.to(pw.dtype)
    cps = _control_points(pw, w)
    alpha = _barycentric(pw, cps)  # [N, 4]

    # M rows (normalized intrinsics: fu=fv=1, uc=vc=0)
    u, v = uv_norm[:, 0], uv_norm[:, 1]
    zero = torch.zeros_like(alpha)
    m_u = torch.stack([alpha, zero, -alpha * u[:, None]], dim=-1)  # [N,4,3]
    m_v = torch.stack([zero, alpha, -alpha * v[:, None]], dim=-1)
    m = torch.cat([m_u, m_v], dim=0).reshape(2 * n, 12)
    m = m * torch.cat([w, w])[:, None]
    _, eve = jacobi_eigh(m.T @ m)  # ascending: first columns ≈ kernel
    vkern = eve[:, :4]  # [12, 4] null-space basis
    rho = _pair_dists2(cps)

    def resid(b):  # [4] → [6]; slices only, as jacfwd needs (no 0-d math)
        return _pair_dists2((vkern @ b).reshape(4, 3)) - rho

    def solve_case(betas):
        b = betas
        for _ in range(gn_iters):
            r = resid(b)
            jac = jacfwd(resid)(b)  # [6, 4]
            jtj = jac.T @ jac + 1e-9 * _eye(4, jac)
            b = b - torch.linalg.solve_ex(jtj, jac.T @ r)[0]
        cc = (vkern @ b).reshape(4, 3)  # camera-frame control points
        # fix sign: points must be in front of the camera (positive z)
        pc = alpha @ cc  # [N, 3]
        zmean = torch.sum(pc[:, 2] * w) / torch.clamp(torch.sum(w), min=1e-9)
        pc = pc * torch.sign(zmean)
        # world→camera via Kabsch: pc ≈ R pw + t
        fit = kabsch(pc, pw, w)
        proj = pw @ fit.r.T + fit.t
        uvp = proj[:, :2] / torch.clamp(proj[:, 2:3], min=1e-9)
        err = torch.sum(torch.linalg.vector_norm(uvp - uv_norm, dim=-1) * w
                        ) / torch.clamp(torch.sum(w), min=1e-9)
        return fit, err

    fit1, err1 = solve_case(_betas_case1(vkern, rho))
    fit2, err2 = solve_case(_betas_case2(vkern, rho))
    pick2 = (err2 < err1) & fit2.ok
    return PnpResult(
        r=torch.where(pick2, fit2.r, fit1.r),
        t=torch.where(pick2, fit2.t, fit1.t),
        ok=(fit1.ok | fit2.ok) & (torch.sum(w) >= 6),
        err=torch.where(pick2, err2, err1))


def _result_packing(dt: torch.dtype) -> Packing:
    e = lambda *shape, dtype=dt: torch.empty(shape, dtype=dtype)  # noqa
    return Packing(PnpResult(e(3, 3), e(3), e(dtype=torch.bool), e()))


def _normalized(cam: Camera, uv_px: torch.Tensor) -> torch.Tensor:
    """Distorted pixels → normalized image coordinates (SR4000 model)."""
    uv = undistort(cam, uv_px)
    return torch.stack([(uv[:, 0] - cam.cx) / cam.f,
                        (uv[:, 1] - cam.cy) / cam.f], dim=-1)


def _epnp_body(cam: Camera | None, gn_iters: int, pout: Packing):
    def body(b, gens):
        pw, uv, valid = b["inp"]
        if cam is not None:
            uv = _normalized(cam, uv)
        pout.pack(_epnp(pw, uv, valid, gn_iters), b["out"])

    return body


def _run_epnp(name, cam, pw, uv, valid, gn_iters) -> PnpResult:
    pout = _result_packing(pw.dtype)
    prog = call_program(name, (cam, gn_iters), [pw, uv, valid], pout)
    prog.run(name, _epnp_body(cam, gn_iters, pout))
    return packed_result(prog, pout)


def epnp(
    pw: torch.Tensor,  # [N, 3] world points
    uv_norm: torch.Tensor,  # [N, 2] normalized image coords (x/z, y/z)
    valid: torch.Tensor,  # [N] bool
    gn_iters: int = 5,
) -> PnpResult:
    """EPnP (see the module docstring): one replay of its program, the
    result the call's own copy."""
    return _run_epnp("epnp", None, pw, uv_norm, valid, gn_iters)


def epnp_camera(cam: Camera, pw, uv_px, valid, gn_iters: int = 5
                ) -> PnpResult:
    """EPnP from *distorted pixel* measurements using the SR4000 camera
    model (undistort + normalize), the form the reference's EPnP
    experiment consumed: ``epnp``'s program with the camera baked in."""
    return _run_epnp("epnp_camera", cam, pw, uv_px, valid, gn_iters)


def _skew_rows(a: torch.Tensor) -> torch.Tensor:
    """[N, 3] → [N, 3, 3] −[a]× (the reference's row layout)."""
    z = torch.zeros_like(a[:, 0])
    return torch.stack([
        torch.stack([z, a[:, 2], -a[:, 1]], -1),
        torch.stack([-a[:, 2], z, a[:, 0]], -1),
        torch.stack([a[:, 1], -a[:, 0], z], -1),
    ], dim=1)


def _dls_terms(pw, uv_n, valid):
    """(w [N], I − v̂v̂ᵀ [N, 3, 3]) of the bearings v̂ of uv_n."""
    v = torch.cat([uv_n, torch.ones_like(uv_n[:, :1])], dim=-1)
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)  # bearings
    return valid.to(pw.dtype), _eye(3, pw)[None] - v[:, :, None] * v[:, None, :]


def _dls_residuals(pw, proj, w, r, t):
    pc = pw @ r.T + t  # [N, 3]
    return torch.einsum("nij,nj->ni", proj, pc) * w[:, None]


def _dls_cost(pw, proj, w, r, t):
    res = _dls_residuals(pw, proj, w, r, t)
    return torch.sum(res * res) / torch.clamp(torch.sum(w), min=1.0)


def _dls_step(pw, proj, w, r, t):
    """One Gauss–Newton step on the object-space cost: (r, t) after the
    axis-angle left increment."""
    res = _dls_residuals(pw, proj, w, r, t)
    # Jacobian of (I−v̂v̂ᵀ)(exp([δθ]×)·Rp + t + δt) wrt [δθ, δt]
    j_rot = torch.einsum("nij,njk->nik", proj, _skew_rows(pw @ r.T))
    jac = torch.cat([j_rot, proj], dim=-1) * w[:, None, None]  # [N,3,6]
    jtj = torch.einsum("nij,nik->jk", jac, jac) + 1e-9 * _eye(6, pw)
    jtr = torch.einsum("nij,ni->j", jac, res)
    delta = -torch.linalg.solve_ex(jtj, jtr)[0]
    dth, dt = delta[:3], delta[3:]
    ang = torch.linalg.vector_norm(dth) + 1e-12
    axis = dth / ang
    z = torch.zeros_like(axis[0])
    k = torch.stack([
        torch.stack([z, -axis[2], axis[1]]),
        torch.stack([axis[2], z, -axis[0]]),
        torch.stack([-axis[1], axis[0], z]),
    ])
    dr = _eye(3, pw) + torch.sin(ang) * k + (1.0 - torch.cos(ang)) * (k @ k)
    return dr @ r, t + dt


def _dls_body(pout: Packing):
    """``dls_pnp``'s program body per variant, on the carry row (r, t, ok,
    err): ``seed`` puts EPnP's pose and its cost there, ``iteration``
    one Gauss–Newton step and the cost at the new pose."""

    def make(variant: str):
        def body(b, gens):
            pw, uv_n, valid = b["inp"]
            w, proj = _dls_terms(pw, uv_n, valid)
            row = pout.unpack(b["out"])
            if variant == "seed":
                seed = _epnp(pw, uv_n, valid, 5)
                r, t, ok = seed.r, seed.t, seed.ok
            else:
                (r, t), ok = _dls_step(pw, proj, w, row.r, row.t), row.ok
            load(row, PnpResult(r, t, ok, _dls_cost(pw, proj, w, r, t)))

        return body

    return make


def dls_pnp(
    pw: torch.Tensor,  # [N, 3] world points
    uv_n: torch.Tensor,  # [N, 2] normalized image coords
    valid: torch.Tensor,  # [N] bool
    iters: int = 10,
) -> PnpResult:
    """Direct least-squares PnP: minimize the object-space error
    Σ‖(I − v̂ᵢv̂ᵢᵀ)(R pᵢ + t)‖² over SE(3) by fixed-iteration Gauss–Newton
    on the manifold (axis-angle left increment), seeded by EPnP — the cost
    the reference's DLS solver minimizes, at the same optimum for the
    seeds EPnP provides. One ``seed`` replay, then one ``iteration``
    replay per iteration (see the module docstring); the result is the
    call's own copy."""
    pout = _result_packing(pw.dtype)
    prog = call_program("dls_pnp", (), [pw, uv_n, valid], pout,
                        carry=("out",))
    body = _dls_body(pout)
    for v in ["seed"] + ["iteration"] * iters:
        prog.run(v, body(v))
    return packed_result(prog, pout)
