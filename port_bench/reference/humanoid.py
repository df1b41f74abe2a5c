"""One control step of the humanoid on the heightfield, then the
observation and the reward that follow it, plain PyTorch.

The dynamics (the configuration's engine; generalized velocity u = [root
COM velocity (3), root angular velocity (3), the 23 joints' world-frame
relative angular velocities (69)]): each substep solves

    A u⁺ = M u + dt·(Q_gravity + Q_bias + Q_spring + Q_contact)

where A = Σ_k m_k Jv_kᵀJv_k + Σ_k Jw_kᵀ R_k I_k R_kᵀ Jw_k (the mass
matrix), plus dt·(damping + dt·kp) on the joints (Stable PD), plus the
implicit contact spring-damper: for each capsule end-sphere that touches
or can touch the ground within the control step, its point Jacobian's
rows weighted by dt·friction damping and its normal row weighted by
dt·(dt·k_n + d_n) − that. The control step's first substep builds the
Jacobians, the contact set and A, and the second reuses them with fresh
penetrations and forces (TGS). The Jacobian rows are rounded to bfloat16
where the configuration stores them so (`rows_bf16`), each √weight
applied in bfloat16; A is formed and solved in float64 (the control: A
in float32 with TF32 matmuls, its factor, the right-hand side and the
solution in bfloat16). Poses integrate on the exponential map, joint
angles are clamped to their limits with the velocity into the limit
removed, and velocities are norm-clamped.

The observation is the heading-local body state with the shape
parameters, the trajectory's next samples, and the height map around the
head; the reward the trajectory-following term minus the power penalty.
Each function here is written from those definitions; nothing of the
program is imported.
"""
from __future__ import annotations

import numpy as np
import torch

from .world import NAMES, NB, NJ, PARENTS

NU = 6 + 3 * NJ
CONTACT = ("Pelvis", "Torso", "Chest", "Head", "L_Knee", "R_Knee",
           "L_Ankle", "R_Ankle", "L_Toe", "R_Toe", "L_Elbow", "R_Elbow",
           "L_Wrist", "R_Wrist")
CONTACT_BODY = np.repeat([NAMES.index(n) for n in CONTACT], 2)
CONTACT_END = np.tile([0, 1], len(CONTACT))
FROZEN = ("L_Toe", "R_Toe", "L_Hand", "R_Hand")
PARENT_J = np.array(PARENTS[1:])


def _anc() -> np.ndarray:
    """anc[a, k] = 1 where column group a (0: the root, j ≥ 1: joint j)
    moves body k."""
    a = np.zeros((NB, NB), np.float32)
    for k in range(NB):
        a[0, k] = 1.0
        j = k
        while j > 0:
            a[j, k] = 1.0
            j = PARENTS[j]
    return a


ANC = _anc()


# --- rotations ([x, y, z, w]) -------------------------------------------------

def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def qmul(a, b):
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw,
                        aw * bw - ax * bx - ay * by - az * bz], -1)


def conj(q):
    return torch.cat([-q[..., :3], q[..., 3:]], -1)


def rot(q, v):
    t = 2.0 * cross(q[..., :3], v)
    return v + q[..., 3:] * t + cross(q[..., :3], t)


def rot_inv(q, v):
    return rot(conj(q), v)


def unit(q):
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                           min=1e-9)


def _axis(like, i):
    e = torch.zeros(like.shape[:-1] + (3,), dtype=like.dtype,
                    device=like.device)
    e[..., i] = 1.0
    return e


def _wrap(x):
    return torch.atan2(torch.sin(x), torch.cos(x))


def from_angle_axis(angle, axis):
    half = 0.5 * angle[..., None]
    axis, half = torch.broadcast_tensors(axis, half)
    return torch.cat([axis * torch.sin(half), torch.cos(half[..., :1])], -1)


def log(q):
    """Exponential-map coordinates of q (angle in [−π, π])."""
    w = torch.clamp(q[..., 3], -1.0, 1.0)
    s = torch.sqrt(torch.clamp(1.0 - w * w, min=1e-18))
    angle = _wrap(2.0 * torch.acos(w))
    ok = s > 1e-5
    axis = torch.where(ok[..., None], q[..., :3]
                       / torch.clamp(s[..., None], min=1e-9), _axis(q, 2))
    return torch.where(ok, angle, torch.zeros_like(angle))[..., None] * axis


def exp(e):
    angle = torch.sqrt(torch.sum(e * e, -1) + 1e-18)
    ok = torch.abs(angle) > 1e-5
    axis = torch.where(ok[..., None], e / torch.clamp(angle[..., None],
                                                      min=1e-9), _axis(e, 2))
    return from_angle_axis(torch.where(ok, _wrap(angle),
                                       torch.zeros_like(angle)), axis)


def matrix(q):
    x, y, z, w = q.unbind(-1)
    m = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y), 2 * (x * y + w * z),
                     1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                     2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)
    return m.reshape(m.shape[:-1] + (3, 3))


def heading(q):
    d = rot(q, _axis(q, 0))
    return torch.atan2(d[..., 1], d[..., 0])


def heading_inv(q):
    return from_angle_axis(-heading(q), _axis(q, 2))


def tan_norm(q):
    return torch.cat([rot(q, _axis(q, 0)), rot(q, _axis(q, 2))], -1)


def skew_neg(r):
    """−[r]×, so that skew_neg(r) @ ω = ω × r."""
    x, y, z = r.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, z, -y, -z, o, x, y, -x, o], -1).reshape(
        r.shape[:-1] + (3, 3))


# --- kinematics ---------------------------------------------------------------

def frames(b, root_pos, root_rot, joint_rot):
    """Body COM positions, world rotations and joint pivots from the
    reduced pose (root_pos the root's COM)."""
    N = root_pos.shape[0]
    local = torch.cat([root_rot[:, None], joint_rot], 1)
    grot = [local[:, 0]]
    piv = [root_pos - rot(root_rot, b["com_off"][:, 0])]
    for k in range(1, NB):
        p = PARENTS[k]
        grot.append(qmul(grot[p], local[:, k]))
        piv.append(piv[p] + rot(grot[p], b["offsets"][:, k]))
    grot, piv = torch.stack(grot, 1), torch.stack(piv, 1)
    x = piv + rot(grot, b["com_off"])
    return x.reshape(N, NB, 3), grot, piv


def body_velocities(x, piv, u):
    """u → each body's COM velocity and angular velocity: v_k = v_root +
    ω_root × (x_k − x_0) + Σ_j q̇_j × (x_k − p_j) over the joints j that
    move k, with the cross products distributed over x_k and p_j."""
    qd = u[:, 6:].reshape(-1, NJ, 3)
    anc = torch.as_tensor(ANC[1:], dtype=u.dtype, device=u.device)
    w_sum = torch.einsum("jk,nji->nki", anc, qd)
    w = u[:, None, 3:6] + w_sum
    v = (u[:, None, 0:3] + cross(u[:, None, 3:6], x - x[:, :1])
         + cross(w_sum, x)
         - torch.einsum("jk,nji->nki", anc, cross(qd, piv[:, 1:])))
    return v, w


def refresh(b, s):
    x, q, piv = frames(b, s["root_pos"], s["root_rot"], s["joint_rot"])
    v, w = body_velocities(x, piv, s["u"])
    return dict(s, body_x=x, body_q=q, body_v=v, body_w=w)


def pivot_frame(b, s):
    """(pos, rot, vel, ang) of each body at its joint pivot."""
    r = rot(s["body_q"], b["com_off"])
    return (s["body_x"] - r, s["body_q"], s["body_v"]
            + cross(s["body_w"], -r), s["body_w"])


def joints(s):
    """(joint angles as exponential maps, joint velocities in the parent
    frame)."""
    qp = s["body_q"][:, PARENT_J]
    return log(s["joint_rot"]), rot_inv(qp, s["u"][:, 6:].reshape(-1, NJ, 3))


# --- the terrain ---------------------------------------------------------------

class Ground:
    """Bilinear heights and normals of an (H, W) grid, and the sensor's
    two-corner minimum."""

    def __init__(self, h, cell, origin, device):
        self.h = torch.as_tensor(h, device=device)
        self.cell, self.origin = cell, origin

    def _cell(self, xy):
        H, W = self.h.shape
        gx = torch.clamp((xy[..., 0] - self.origin[0]) / self.cell, 0.0,
                         H - 1.001)
        gy = torch.clamp((xy[..., 1] - self.origin[1]) / self.cell, 0.0,
                         W - 1.001)
        x0, y0 = torch.floor(gx).long(), torch.floor(gy).long()
        return x0, y0, gx - x0, gy - y0

    def height_normal(self, xy):
        x0, y0, fx, fy = self._cell(xy)
        h = self.h
        h00, h10, h01, h11 = (h[x0, y0], h[x0 + 1, y0], h[x0, y0 + 1],
                              h[x0 + 1, y0 + 1])
        z = (h00 * (1 - fx) * (1 - fy) + h10 * fx * (1 - fy)
             + h01 * (1 - fx) * fy + h11 * fx * fy)
        dx = ((h10 - h00) * (1 - fy) + (h11 - h01) * fy) / self.cell
        dy = ((h01 - h00) * (1 - fx) + (h11 - h10) * fx) / self.cell
        n = torch.stack([-dx, -dy, torch.ones_like(dx)], -1)
        return z, n / torch.linalg.norm(n, dim=-1, keepdim=True)

    def low(self, x, y):
        x0, y0, _, _ = self._cell(torch.stack([x, y], -1))
        return torch.minimum(self.h[x0, y0], self.h[x0 + 1, y0 + 1])


# --- the step ---------------------------------------------------------------

def contact_points(b, x, q):
    a = b["axis"] * b["half"][..., None]
    ends = x[:, :, None] + rot(q[:, :, None], torch.stack([-a, a], 2))
    return ends[:, CONTACT_BODY, CONTACT_END]


def _bf(t):
    return t.to(torch.bfloat16)


def jacobian_rows(b, x, q, pts):
    """The angular blocks (bf16) of the bodies' velocity rows G (N, 72,
    72), their inertia rows W (N, 72, 72) and the contact points' rows Gc
    (N, 3C, 72): column group a of body k holds −[x_k − p_a]× where a
    moves k, with p_0 the root's COM and p_j joint j's pivot."""
    N = x.shape[0]
    piv = x[:, 1:] - rot(q[:, 1:], b["com_off"][:, 1:])
    P = torch.cat([x[:, :1], piv], 1)                      # (N, 24, 3)
    anc = torch.as_tensor(ANC, dtype=x.dtype, device=x.device)
    # (N, k, a, 3, 3) blocks, then rows 3k + i, columns 3a + j
    G = skew_neg(x[:, :, None] - P[:, None]) * anc.T[None, :, :, None, None]
    G = _bf(G.permute(0, 1, 3, 2, 4).reshape(N, 3 * NB, 3 * NB))
    R = matrix(q)                                          # (N, k, 3, 3)
    sD = torch.sqrt(b["inertia"])
    # W[3k + i, 3a + j] = √I_k,i · R_k[j, i] where a moves k
    Wb = (sD[:, :, :, None] * R.transpose(-1, -2))[:, :, None] \
        * anc.T[None, :, :, None, None]                    # (N, k, a, i, j)
    W = _bf(Wb.permute(0, 1, 3, 2, 4).reshape(N, 3 * NB, 3 * NB))
    # a point's lever from each pivot in bf16 coordinates, rounded once
    body = torch.as_tensor(CONTACT_BODY, device=x.device)
    lever = _bf(pts).float()[:, :, None] - _bf(P).float()[:, None]
    Gc = skew_neg(lever) * anc.T[body][None, :, :, None, None]
    C = pts.shape[1]
    Gc = _bf(Gc.permute(0, 1, 3, 2, 4).reshape(N, 3 * C, 3 * NB))
    return G, W, Gc


def gravity_bias_spring(b, s, target_q, g):
    """The linear body forces f (N, 24, 3) (gravity less the velocity-
    product acceleration) and the rest of the generalized force (N, 75):
    the gyroscopic torques and the torque-limited PD spring toward the
    target joint rotations."""
    x, q, vb, wb, u = (s["body_x"], s["body_q"], s["body_v"], s["body_w"],
                       s["u"])
    N = x.shape[0]
    anc = torch.as_tensor(ANC, dtype=x.dtype, device=x.device)
    qd = u[:, 6:].reshape(N, NJ, 3)
    par = torch.as_tensor(PARENT_J, device=x.device)
    piv = x[:, 1:] - rot(q[:, 1:], b["com_off"][:, 1:])
    v_piv = vb[:, par] + cross(wb[:, par], piv - x[:, par])
    w_sum = torch.einsum("jk,nji->nki", anc[1:], qd)
    a_vp = (cross(u[:, None, 3:6], vb - vb[:, :1]) + cross(w_sum, vb)
            - torch.einsum("jk,nji->nki", anc[1:], cross(qd, v_piv)))
    Iw = rot(q, b["inertia"] * rot_inv(q, wb))
    f = b["mass"][..., None] * (g - a_vp)
    tau = -cross(wb, Iw)                                   # (N, 24, 3)
    Q = torch.zeros((N, NU), dtype=x.dtype, device=x.device)
    Q[:, 3:] = torch.einsum("ak,nki->nai", anc, tau).reshape(N, -1)
    qp = q[:, par]
    err = qmul(qmul(conj(qp), q[:, 1:]), conj(target_q))
    spring = -b["kp"][..., None] * rot(qp, log(err))
    n = torch.linalg.norm(spring, dim=-1, keepdim=True)
    spring = spring * (torch.minimum(n, b["torque_limit"][..., None])
                       / torch.clamp(n, min=1e-9))
    Q[:, 6:] += spring.reshape(N, -1)
    return f, Q


def _clamp_norm(v, cap):
    n = torch.linalg.norm(v, dim=-1, keepdim=True)
    return v * (torch.clamp(n, max=cap) / torch.clamp(n, min=1e-9))


def integrate(b, s, u, dt):
    N = u.shape[0]
    qd = u[:, 6:].reshape(N, NJ, 3)
    qp = s["body_q"][:, PARENT_J]
    root_pos = s["root_pos"] + dt * u[:, :3]
    root_rot = unit(qmul(exp(u[:, 3:6] * dt), s["root_rot"]))
    jr = unit(qmul(exp(rot_inv(qp, qd) * dt), s["joint_rot"]))
    th = log(jr)
    lim = b["joint_limit"]
    th_cl = torch.maximum(torch.minimum(th, lim), -lim)
    hit = torch.abs(th - th_cl) > 1e-7
    jr = torch.where(hit.any(-1, keepdim=True), exp(th_cl), jr)
    qd = rot(qp, torch.where(hit, 0.0, rot_inv(qp, qd)))
    u = torch.cat([u[:, :6], qd.reshape(N, -1)], -1)
    return refresh(b, dict(s, root_pos=root_pos, root_rot=root_rot,
                           joint_rot=jr, u=u))


def physics(b, ground: Ground, s: dict, target_q, e: dict,
            control: bool = False, given=None) -> list:
    """One control step from the state `s` (root_pos, root_rot, joint_rot,
    u and the body cache) toward the target joint rotations: the state
    after each substep. With `given` (the states another stepper reached
    after each substep) each later substep starts from the given state
    before it, so that each is judged alone."""
    n_sub = int(e["n_substeps"])
    dt = e["control_dt"] / n_sub
    dev = s["u"].device
    g = torch.tensor([0.0, 0.0, e["gravity"]], device=dev)
    k_n, d_n = e["contact_stiffness"], e["contact_damping"]
    x, q = s["body_x"], s["body_q"]
    N = x.shape[0]
    body = torch.as_tensor(CONTACT_BODY, device=dev)
    radius = b["radius"][:, body]

    pts = contact_points(b, x, q)
    G, W, Gc = jacobian_rows(b, x, q, pts)
    h0, nrm = ground.height_normal(pts[..., :2])
    pen = (h0 + radius - pts[..., 2]) * nrm[..., 2]
    active = (pen > 0.0).float()
    vpt = s["body_v"][:, body] + cross(s["body_w"][:, body],
                                       pts - x[:, body])
    vn = torch.sum(vpt * nrm, -1)
    vt = torch.linalg.norm(vpt - nrm * vn[..., None], dim=-1)
    mu = torch.where(vt < e["friction_vel_ref"], e["static_friction"],
                     e["dynamic_friction"])
    pen_f = torch.clamp(pen, max=e["max_depenetration"])
    # the rows of a contact that can engage within the control step
    reach = (-e["control_dt"] * torch.clamp(vn, max=0.0)
             + 0.5 * abs(e["gravity"]) * e["control_dt"] ** 2)
    pen_pred = pen + reach
    act_lhs = (pen_pred > 0.0).float()
    d_t = torch.clamp(mu * (k_n * torch.clamp(pen_pred, 0.0,
                                              e["max_depenetration"]))
                      / (vt + e["friction_vel_ref"]),
                      max=e["max_friction_damping"])
    wn = act_lhs * dt * (dt * k_n + d_n)
    wt = act_lhs * dt * d_t
    C = pts.shape[1]
    nb = _bf(nrm)
    prod = (nb.reshape(N, 3 * C)[..., None] * Gc).float().reshape(
        N, C, 3, 3 * NB)
    Jn = _bf(prod[:, :, 0] + prod[:, :, 1] + prod[:, :, 2])

    def sq(w):
        return torch.sqrt(_bf(w))[..., None]
    eye = _bf(torch.eye(3, device=dev)).repeat(NB, 1).expand(N, -1, -1)
    eyec = _bf(torch.eye(3, device=dev)).repeat(C, 1).expand(N, -1, -1)
    S = torch.cat([
        torch.cat([eye, G], -1) * sq(b["mass"].repeat_interleave(3, -1)),
        torch.cat([torch.zeros_like(eye), W], -1),
        torch.cat([eyec, Gc], -1) * sq(wt.repeat_interleave(3, -1)),
        torch.cat([nb, Jn], -1) * sq(wn - wt)], 1)
    jd = dt * b["kd"] + dt * dt * b["kp"]
    diag = torch.cat([torch.full((N, 3), dt * e["linear_damping"],
                                 device=dev),
                      torch.full((N, 3), dt * e["angular_damping"],
                                 device=dev),
                      jd.repeat_interleave(3, -1)], -1)
    if control:
        prev = torch.backends.cuda.matmul.fp32_precision
        torch.backends.cuda.matmul.fp32_precision = "tf32"
        Sf = S.float()
        A = torch.bmm(Sf.transpose(1, 2), Sf)
        torch.backends.cuda.matmul.fp32_precision = prev
    else:
        Sd = S.double()
        A = torch.bmm(Sd.transpose(1, 2), Sd)
    A = A + torch.diag_embed(diag.to(A.dtype) + 1e-8)
    L = torch.linalg.cholesky(A)
    # the control keeps the factor, the right-hand side and the solution in
    # bfloat16 (factored in float32: A rounded first is not positive
    # definite for every env)
    r = _bf if control else (lambda t: t)
    L = r(L).to(A.dtype)

    def solve(s, pen_f_m):
        f, Q = gravity_bias_spring(b, s, target_q, g)
        kpen = k_n * pen_f_m
        Q = Q + torch.cat([torch.einsum("nc,nci->ni", kpen, nrm),
                           torch.einsum("nc,ncd->nd", kpen, Jn.float())], -1)
        fvec = b["mass"][..., None] * s["body_v"] + dt * f
        fm = _bf(fvec.reshape(N, -1)).to(A.dtype)
        v2 = _bf((torch.sqrt(b["inertia"]) * rot_inv(s["body_q"],
                                                     s["body_w"])
                  ).reshape(N, -1)).to(A.dtype)
        ang = (torch.einsum("nmc,nm->nc", G.to(A.dtype), fm)
               + torch.einsum("nmc,nm->nc", W.to(A.dtype), v2))
        rhs = torch.cat([fvec.sum(1).to(A.dtype), ang], -1) + dt * Q.to(
            A.dtype)
        u = r(torch.cholesky_solve(r(rhs).to(A.dtype)[..., None], L)[..., 0]
              ).float()
        return torch.cat([
            _clamp_norm(u[:, :3], e["max_linear_velocity"]),
            _clamp_norm(u[:, 3:6], e["max_angular_velocity"]),
            _clamp_norm(u[:, 6:].reshape(N, NJ, 3),
                        e["max_angular_velocity"]).reshape(N, -1)], -1)

    out = [integrate(b, s, solve(s, active * pen_f), dt)]
    for k in range(n_sub - 1):
        s = out[-1] if given is None else given[k]
        p = contact_points(b, s["body_x"], s["body_q"])
        pen = (h0 + radius - p[..., 2]) * nrm[..., 2]
        act = (pen > 0.0).float()
        out.append(integrate(b, s, solve(s, act * torch.clamp(
            pen, max=e["max_depenetration"])), dt))
    return out


# --- the environment's step ----------------------------------------------------

def pd_targets(b, actions):
    """Actions (N, 69) → target joint exponential maps: each joint's axes
    scaled by 1.2·its largest limit (at most π; the knees' second axis 5),
    the toes and hands frozen."""
    lim = b["joint_limit"][0]
    scale = torch.clamp(1.2 * lim.abs().amax(-1, keepdim=True),
                        max=float(np.pi)).expand(NJ, 3).clone()
    for k in ("L_Knee", "R_Knee"):
        scale[NAMES.index(k) - 1, 1] = 5.0
    mask = torch.ones((NJ, 1), device=actions.device)
    for k in FROZEN:
        mask[NAMES.index(k) - 1] = 0.0
    return actions.reshape(-1, NJ, 3) * scale[None] * mask[None]


def path_at(verts, times, duration):
    """The trajectory's vertex chain, interpolated at `times` (n, ...)."""
    V = verts.shape[1]
    n = times.shape[0]
    seg = torch.clamp(times / duration, 0.0, 1.0) * (V - 1)
    i0 = torch.clamp(torch.floor(seg).long(), 0, V - 2)
    f = (seg - i0).reshape(n, -1, 1)
    idx = i0.reshape(n, -1, 1).expand(-1, -1, 3)
    a, c = torch.gather(verts, 1, idx), torch.gather(verts, 1, idx + 1)
    return ((1.0 - f) * a + f * c).reshape(times.shape + (3,))


def sensor_grid(extent, res, device):
    lin = np.linspace(-extent, extent, res)
    gx, gy = np.meshgrid(lin, lin, indexing="ij")
    return torch.as_tensor(np.stack([gx.ravel(), gy.ravel()], -1).astype(
        np.float32), device=device)


def observe(b, ground: Ground, s, verts, progress, env: dict):
    pos, grot, vel, ang = pivot_frame(b, s)
    N = pos.shape[0]
    root, root_rot = pos[:, 0], grot[:, 0]
    hq = heading_inv(root_rot)
    local = rot(hq[:, None], pos - root[:, None])[:, 1:].reshape(N, -1)
    rots = tan_norm(qmul(hq[:, None].expand(grot.shape), grot))
    self_obs = torch.cat([local, rots.reshape(N, -1),
                          rot(hq[:, None], vel).reshape(N, -1),
                          rot(hq[:, None], ang).reshape(N, -1),
                          b["betas"][:, :11]], -1)
    times = progress.float() * env["dt"]
    offs = torch.arange(env["num_traj_samples"], device=pos.device) \
        * env["traj_sample_timestep"]
    samples = path_at(verts, times[:, None] + offs[None],
                      env["episode_dur"])
    loc = rot(hq[:, None], samples - root[:, None])[..., :2].reshape(N, -1)
    head = pos[:, NAMES.index("Head")]
    yaw = heading(root_rot)
    c, s_ = torch.cos(yaw)[:, None], torch.sin(yaw)[:, None]

    def around(grid, o):
        gx, gy = grid[:, 0][None], grid[:, 1][None]
        return c * gx - s_ * gy + o[:, 0:1], s_ * gx + c * gy + o[:, 1:2]
    h = ground.low(*around(sensor_grid(env["sensor_extent"],
                                       env["sensor_res"], pos.device),
                           head[:, :2]))
    ch = ground.low(*around(sensor_grid(0.15, 3, pos.device),
                            root[:, :2])).mean(-1, keepdim=True)
    hmap = torch.clamp(ch - h, -3.0, 3.0) * env["height_meas_scale"]
    return torch.cat([self_obs, loc, hmap], -1)


def reward(b, s, verts, progress, target, env: dict):
    """The trajectory-following reward less the power penalty, after the
    step (`progress` counted after it)."""
    tar = path_at(verts, progress.float() * env["dt"], env["episode_dur"])
    err = torch.sum((tar[:, :2] - s["body_x"][:, 0, :2]) ** 2, -1)
    loc = env["location_coefficient"] * torch.exp(-2.0 * err)
    dof, dvel = joints(s)
    tau = b["kp"][..., None] * (target - dof) - b["kd"][..., None] * dvel
    n = torch.linalg.norm(tau, dim=-1, keepdim=True)
    tau = tau * (torch.minimum(n, b["torque_limit"][..., None])
                 / torch.clamp(n, min=1e-9))
    power = torch.abs(tau * dvel).sum((-2, -1))
    return loc - env["power_coefficient"] * power


def rounded(t: dict) -> dict:
    """The state with every entry rounded to bfloat16 (the observation's
    and the reward's control)."""
    return {k: v.to(torch.bfloat16).float() for k, v in t.items()}


def control_step(b, ground, s, actions, verts, progress, env, e,
                 given=None, control=False):
    """(the state after each substep, the observation and the reward) of
    one env step from `s`, no reset: the caller compares the envs the step
    did not end. With `given` (the states the program reached after each
    of its substeps) each substep starts from the program's state before
    it, and the observation and the reward read the program's last state.
    The control: the Gram in TF32 and the solve in bfloat16, the
    observation and the reward from the state in bfloat16."""
    target = pd_targets(b, actions)
    subs = physics(b, ground, s, exp(target), e, control, given)
    last = subs[-1] if given is None else given[-1]
    if control:
        last = rounded(last)
    p1 = progress + 1
    return (subs, observe(b, ground, last, verts, p1, env),
            reward(b, last, verts, p1, target, env))
