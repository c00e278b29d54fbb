"""Parity of the port's trainer parameter hand-over and adaptive density
control with the JAX reference on the CPU: `parallel.distributed.
materialize_splats` (and its VJP at the clip and abs bounds),
`train.densify` (`accumulate`, `densify_step`, `reset_opt_slots`,
`pad_params`, `alive_count`).

The inputs are made from a seed with numpy and handed to both sides.
`densify_step`'s only random numbers, the split offsets' normal draws, are
the reference's (`jax.random.normal` of the event's key) handed over
through numpy in place of the port's torch.Generator draws
(`densify.normal_draws`).

Tolerances:
  * integers and masks (`changed`, every count) equal; pruned, refilled and
    untouched slots bit-equal; split children's positions (the draws
    rotated by a float32 quaternion on each side) and everything else
    within 1e-6 of each field's max;
  * `materialize_splats`' VJP within 1e-6 of each field's max |g| of
    `jax.vjp`, and the color cotangent at a clip bound exactly half the
    incoming one on both sides (jnp.clip's tie; torch.clamp would pass
    all of it);
  * `reset_opt_slots`: Adam's moments masked bit-equal to optax's mu / nu,
    the step count kept.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from fourdgs.parallel import distributed as RDIST  # noqa: E402
from fourdgs.train import densify as RD  # noqa: E402
from fourdgs_torch.parallel import distributed as TDIST  # noqa: E402
from fourdgs_torch.train import densify as TD  # noqa: E402

N = 64
FIELDS = TDIST.PARAM_FIELDS
TOL = 1e-6


def _params(seed=0, n=N):
    """Trainer parameters with pruned splats (alpha below 5e-3), splats
    above the split scale and below it."""
    rng = np.random.default_rng(seed)
    color = rng.uniform(0.2, 1.0, (n, 4)).astype(np.float32)
    k = n // 5
    color[rng.permutation(n)[:k], 3] = rng.uniform(0, 4e-3, k)
    scale = rng.uniform(0.5, 1.8, (n, 3)).astype(np.float32)
    big = rng.permutation(n)[:n // 3]
    scale[big, rng.integers(0, 3, big.size)] = rng.uniform(2.5, 4.0, big.size)
    scale *= np.where(rng.random((n, 3)) < 0.2, -1, 1).astype(np.float32)
    return dict(
        position4=rng.uniform(-5, 5, (n, 4)).astype(np.float32),
        quat=rng.normal(size=(n, 4)).astype(np.float32),
        scale3=scale,
        lifetime=rng.uniform(0.5, 3.0, n).astype(np.float32),
        fade=rng.uniform(0.2, 0.8, n).astype(np.float32),
        velocity=rng.normal(size=(n, 3)).astype(np.float32),
        color=color)


def _grad_accum(seed=1, n=N):
    """Accumulated positional-gradient norms over 3 steps: fewer candidates
    above the 2e-6 average threshold than pruned slots, with ties."""
    rng = np.random.default_rng(seed)
    acc = (rng.uniform(0, 2e-5, n) * (rng.random(n) < 0.12)).astype(np.float32)
    acc[5] = acc[9] = acc[17] = np.float32(1.5e-5)           # tied candidates
    return acc


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(params):
    return {k: torch.from_numpy(v.copy()) for k, v in params.items()}


def _j(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


# ---------------------------------------------------------------------------
# materialize_splats and the hand-over
# ---------------------------------------------------------------------------

def _bound_params():
    """Parameters with entries exactly at jnp.clip's bounds (color 0 and 1,
    fade 1e-3 and 1 - 1e-3 as float32) and at abs's kink (scale and
    lifetime 0)."""
    p = _params(2, 16)
    p["color"][0] = [0.0, 1.0, 0.0, 1.0]
    p["color"][1, 3] = 0.0
    p["fade"][2] = np.float32(1e-3)
    p["fade"][3] = np.float32(1.0 - 1e-3)
    p["fade"][4] = 0.0                       # clipped up to 1e-3: no grad
    p["scale3"][5] = [0.0, 1.0, -1.0]
    p["lifetime"][6] = 0.0
    return p


def test_splats_to_params_hands_over():
    p = _params()
    got = TDIST.splats_to_params(*(p[k] for k in FIELDS), device="cpu")
    want = RDIST.splats_to_params(*(p[k] for k in FIELDS))
    assert list(got) == list(want) == list(FIELDS)
    for k in FIELDS:
        assert got[k].dtype == torch.float32 and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_materialize_splats_and_vjp_at_the_bounds():
    p = _bound_params()
    rng = np.random.default_rng(3)
    n = p["color"].shape[0]
    cot = {f: rng.normal(size=(n,) + s).astype(np.float32) for f, s in
           (("position", (4,)), ("color", (4,)), ("cov", (4, 4)))}

    @jax.jit
    def ref(q, c):
        out, vjp = jax.vjp(RDIST.materialize_splats, q)
        return out, vjp(type(out)(**c))[0]
    want, g_ref = ref(_j(p), _j(cot))

    leaves = {k: v.requires_grad_(True) for k, v in _t(p).items()}
    got = TDIST.materialize_splats(leaves)
    for f in ("position", "color", "cov"):
        w = np.asarray(getattr(want, f))
        assert _rel(getattr(got, f).detach().numpy(), w) <= TOL, f
    torch.autograd.backward([getattr(got, f) for f in cot],
                            [torch.from_numpy(v) for v in cot.values()])
    for k in FIELDS:
        assert _rel(leaves[k].grad.numpy(), np.asarray(g_ref[k])) <= TOL, k
    # The ties: half of the incoming color cotangent at a bound, as the
    # reference; nothing through a clipped-away fade.
    for i, j in ((0, 0), (0, 1), (0, 3), (1, 3)):
        half = 0.5 * cot["color"][i, j]
        assert leaves["color"].grad[i, j].item() == pytest.approx(half)
        assert float(g_ref["color"][i, j]) == pytest.approx(half)
    assert leaves["fade"].grad[4].item() == 0.0 == float(g_ref["fade"][4])
    for i in (2, 3):
        assert leaves["fade"].grad[i].item() != 0.0
    # abs at 0: gradient +1 (jnp.abs), not 0 (torch.abs).
    assert leaves["scale3"].grad[5, 0].item() != 0.0
    assert leaves["lifetime"].grad[6].item() != 0.0


# ---------------------------------------------------------------------------
# densification
# ---------------------------------------------------------------------------

def test_accumulate_matches_reference():
    rng = np.random.default_rng(4)
    grads = {"position4": rng.normal(size=(N, 4)).astype(np.float32) * 1e-5}
    acc = _grad_accum()
    want = RD.accumulate(RD.DensifyState(jnp.asarray(acc), jnp.asarray(2)),
                         {"position4": jnp.asarray(grads["position4"])})
    steps = torch.tensor(2, dtype=torch.int32)
    got = TD.accumulate(TD.DensifyState(torch.from_numpy(acc), steps),
                        {"position4": torch.from_numpy(grads["position4"])})
    assert int(got.steps) == int(want.steps) == 3
    assert _rel(got.grad_accum.numpy(), np.asarray(want.grad_accum)) <= TOL


@pytest.fixture(scope="module")
def densified():
    """One densify event from one state on both sides, the reference's
    draws handed over."""
    p = _params()
    acc, steps = _grad_accum(), 3
    key = jax.random.PRNGKey(5)
    cfg = dict(grad_thresh=2e-6, split_scale=2.0, split_factor=1.6,
               prune_alpha=5e-3)
    want, wstate, winfo = jax.jit(lambda q, s, k: RD.densify_step(
        q, s, k, RD.DensifyConfig(**cfg)))(
            _j(p), RD.DensifyState(jnp.asarray(acc), jnp.asarray(steps)), key)
    draws = np.array(jax.random.normal(key, (N, 3), jnp.float32))
    calls = []

    def ref_draws(gen, shape, like):
        calls.append(shape)
        return torch.from_numpy(draws)
    params = _t(p)
    held = {k: v for k, v in params.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TD, "normal_draws", ref_draws)
        got, gstate, ginfo = TD.densify_step(
            params, TD.DensifyState(torch.from_numpy(acc),
                                    torch.tensor(steps, dtype=torch.int32)),
            None, TD.DensifyConfig(**cfg))
    assert calls == [(N, 3)]
    return dict(p=p, want=want, wstate=wstate, winfo=winfo, got=got,
                gstate=gstate, ginfo=ginfo, held=held)


def test_densify_step_counts_and_changed_equal(densified):
    w, g = densified["winfo"], densified["ginfo"]
    for k in ("n_pruned", "n_placed", "n_split", "n_cloned"):
        assert int(g[k]) == int(w[k]), k
    # The state exercises every branch: prunes, splits, clones, and freed
    # slots left empty.
    assert int(w["n_split"]) > 0 and int(w["n_cloned"]) > 0
    assert int(w["n_pruned"]) > int(w["n_placed"]) > 0
    np.testing.assert_array_equal(g["changed"].numpy(),
                                  np.asarray(w["changed"]))
    assert g["changed"].dtype == torch.bool
    assert int(densified["gstate"].steps) == 0
    assert not densified["gstate"].grad_accum.any()


def test_densify_step_parameters_match(densified):
    """Every field within TOL of its max; unchanged slots bit-equal to the
    input, and written in place into the tensors that were handed in."""
    want, got, p = densified["want"], densified["got"], densified["p"]
    changed = np.asarray(densified["winfo"]["changed"])
    for k in FIELDS:
        assert got[k] is densified["held"][k], k
        g, w = got[k].numpy(), np.asarray(want[k])
        assert _rel(g, w) <= TOL, k
        np.testing.assert_array_equal(g[~changed], p[k][~changed], err_msg=k)
    # Pruned slots that got no child are silenced to alpha 0 exactly.
    alpha = got["color"][:, 3].numpy()
    assert np.all(alpha[(p["color"][:, 3] <= 5e-3)] >= 0)
    assert (alpha == 0).sum() == int(densified["winfo"]["n_pruned"]) - int(
        densified["winfo"]["n_placed"])


def test_reset_opt_slots_matches_optax(densified):
    """Adam's per-slot moments zeroed at `changed` as optax's mu / nu are;
    the step count kept."""
    rng = np.random.default_rng(6)
    p = densified["p"]
    changed = densified["winfo"]["changed"]
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in
              p.items()} for _ in range(2)]
    opt = optax.adam(1e-2)

    @jax.jit
    def ref(q, gs, ch):
        state = opt.init(q)
        for g in gs:
            _, state = opt.update(g, state, q)
        return RD.reset_opt_slots(state, ch, N)
    want = ref(_j(p), [_j(g) for g in grads], changed)

    leaves = {k: v.requires_grad_(True) for k, v in _t(p).items()}
    topt = torch.optim.Adam(list(leaves.values()), lr=1e-2)
    for g in grads:
        for k, v in leaves.items():
            v.grad = torch.from_numpy(g[k])
        topt.step()
    TD.reset_opt_slots(topt, densified["ginfo"]["changed"], N)
    mu, nu = want[0].mu, want[0].nu
    for k, v in leaves.items():
        st = topt.state[v]
        assert float(st["step"]) == 2 == int(want[0].count)
        ch = np.asarray(changed)
        for name, ref in (("exp_avg", mu[k]), ("exp_avg_sq", nu[k])):
            got = st[name].numpy()
            assert np.all(got[ch] == 0) and np.all(np.asarray(ref)[ch] == 0)
            assert _rel(got, np.asarray(ref)) <= TOL, (k, name)


def test_pad_params_and_alive_count():
    p = _params()
    want = RD.pad_params(_j(p), 100)
    got = TD.pad_params(_t(p), 100)
    assert list(got) == list(want)
    for k in FIELDS:
        assert got[k].shape[0] == 100
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert TD.pad_params(got, 80) is got
    for alpha in (5e-3, 0.3):
        assert int(TD.alive_count(got, alpha)) == int(
            RD.alive_count(want, alpha))
    assert int(TD.alive_count(got)) == int((p["color"][:, 3] > 5e-3).sum())


def test_densify_makes_no_host_read():
    """densify_step, accumulate and reset_opt_slots read nothing back to
    the host: on the meta device (no data) they run to the end."""
    p = {k: torch.from_numpy(v).to("meta") for k, v in _params().items()}
    state = TD.accumulate(TD.init_state(N, device="meta"),
                          {"position4": p["position4"]})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TD, "normal_draws",
                   lambda gen, shape, like: torch.empty(shape, device="meta"))
        _, new_state, info = TD.densify_step(p, state, None)
    assert info["changed"].device.type == "meta"
    assert new_state.grad_accum.device.type == "meta"
