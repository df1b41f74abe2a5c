"""The flop counts of `counts/` against torch.utils.flop_counter on the
plain reference's own computations, on the CPU at small sizes; the
block-arrow counts on the dense pattern."""
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import ROOT  # noqa: F401  (puts the repository on the path)
from port_bench import weights
from port_bench.counts import arrow, networks
from port_bench.reference import policy, transmotion, valuenet

D = dict(self_obs=12, task_obs=20, traj_obs=6, amp_obs=18, actions=69,
         mlp_units=[32, 16], task_units=[24, 8], disc_units=[16, 8],
         value_units=[5, 3], sigma_init=-2.9)


def counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_policy_minibatch_and_rollout():
    g = torch.Generator().manual_seed(0)
    p = weights.make(policy.param_spec(D), 1, "cpu")
    rows, half, demo = 10, 4, 6
    obs = D["self_obs"] + D["task_obs"]
    mb = dict(obs_n=torch.randn(rows, obs, generator=g),
              flip_obs_n=torch.randn(rows, obs, generator=g),
              action=torch.randn(rows, 69, generator=g),
              logp=torch.randn(rows, generator=g),
              adv=torch.randn(rows, generator=g),
              ret_n=torch.randn(rows, generator=g),
              ret_01=torch.rand(rows, generator=g),
              amp_n=torch.randn(rows, 18, generator=g))
    ac = dict(e_clip=0.2, actor_coef=1, critic_coef=5, bounds_coef=10,
              disc_coef=5, tv_coef=5, sym_coef=1, motion_sym_loss=True,
              disc_logit_reg=0.01, disc_grad_penalty=5,
              disc_weight_decay=1e-4)

    def step():
        q = {k: v.clone().requires_grad_() for k, v in p.items()}
        loss = policy.minibatch_loss(q, D, ac, mb,
                                     torch.randn(demo, 18, generator=g),
                                     torch.randn(half, 18, generator=g),
                                     None)
        torch.autograd.grad(loss, list(q.values()))
    assert counted(step) == networks.policy_minibatch(D, rows, half, demo)
    assert counted(lambda: policy.heads(p, D, mb["obs_n"])) == \
        networks.policy_rollout_step(D, rows)
    assert counted(lambda: policy.disc(p, mb["amp_n"])) == \
        networks.disc_forward(D, rows)


def test_valuenet_step():
    p = weights.make(valuenet.param_spec(13), 1, "cpu")
    n = 7
    s = dict(wp=torch.randn(n, 13, 2), pose=torch.randn(n, 24, 3),
             vel=torch.randn(n, 2), target=torch.rand(n),
             valid=torch.ones(n))

    def step():
        q = {k: v.clone().requires_grad_() for k, v in p.items()}
        torch.autograd.grad(valuenet.masked_mse(q, s), list(q.values()))
    assert counted(step) == networks.valuenet_step(n, 13)


def test_transmotion_step():
    c = dict(nhid=16, nhead=2, dim_ff=24, nlayers_local=2, nlayers_global=1,
             nmode=3, dropout=0.1, mask_traj=0.2, mask_joints=0.2,
             mask_modality=0.3, mask_frame=0.2)
    B, N = 2, 3
    p = weights.make(transmotion.param_spec(c), 1, "cpu")
    vp = weights.make(valuenet.param_spec(13), 2, "cpu")
    g = torch.Generator().manual_seed(3)
    batch = (torch.randn(B, 9, N, 49, 4, generator=g),
             torch.ones(B, N, dtype=torch.bool),
             torch.randn(B, 12, 2, generator=g),
             torch.randn(B, 24, 3, generator=g), torch.randn(B, 2,
                                                             generator=g))
    pc = dict(valueloss_weight=0.3)

    def step():
        q = {k: v.clone().requires_grad_() for k, v in p.items()}
        loss = transmotion.loss(q, vp, c, pc, batch,
                                torch.Generator().manual_seed(4))
        torch.autograd.grad(loss, list(q.values()))
    assert counted(step) == networks.transmotion_step(c, B, N)


def test_arrow_counts_on_the_dense_pattern():
    M = 6
    w = arrow.work((), 0, M)
    assert w["factor_bytes"] == (M * (M + 1) // 2 + M * M) * 4
    assert w["resolve_bytes"] == (M * (M + 1) // 2 + 2 * M) * 4
    assert w["factor_flops"] == sum(1 + r + r * (r + 1)
                                    for r in range(M - 1, -1, -1))
    assert w["resolve_flops"] == 2 * (2 * (M * (M + 1) // 2 - M) + M)
    assert arrow.gram_flops(10, M) == 10 * M * (M + 1)
