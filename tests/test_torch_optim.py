"""The fit step's Adam update (``vrt_torch.diff.optim``) against optax's and
vrt's jitted fit steps, on the CPU.

- ``Adam.apply`` on CPU tensors is ``update`` followed by ``apply_updates``
  bit for bit, on a dict of leaves and on the one tensor of a slab step;
- ``Adam.apply`` equals ``optax.adam`` + ``optax.apply_updates`` over 5
  steps with gradients from 1 to 1e-4 (rtol 1e-6, as
  ``tests/test_torch_fit.py::test_adam_matches_optax``);
- the bias corrections, now formed on the count's device from a Python
  scalar, equal the former ``1 - torch.pow(torch.tensor(b), steps)`` bit
  for bit over steps 1 to 10^4 and at the saturated count;
- ``make_fit_step`` and ``make_fit_step_view``, with and without
  ``sdf_smooth``, track vrt's jitted steps over 2 steps (losses rtol 1e-4,
  the parameters as ``test_three_fit_steps_match_vrt`` holds them);
- ``Adam.apply`` refuses a leaf that is not f32, and the Adam kernel's
  wrapper refuses CPU tensors without launching.

The kernel itself runs only on the card: ``tests/test_torch_kernels.py``
holds it bit for bit against its plain version there.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as ge
from tests.test_torch_host import scene_fields
from vrt.render.gpuscene import RenderMode as VMode
from vrt_torch.diff import fit as tfit
from vrt_torch.diff import optim as toptim
from vrt_torch.diff.optim import AdamState, adam, apply_updates, sgd
from vrt_torch.kernels import optim as ko
from vrt_torch.render.gpuscene import RenderMode, scene_from_numpy

vfit = __import__("vrt.diff.fit", fromlist=["fit"])

torch.set_num_threads(2)

FIT_CAMS = [dict(position=np.asarray([320.0, 0.0, 40.0], np.float32),
                 rotation=np.asarray([0.0, 0.0, 1.0, 0.0], np.float32),
                 fov=60.0)]


def _tree(kind, rng):
    """A parameter tree: the fit's dict of two leaves, or a slab step's one
    tensor of planes."""
    if kind == "slab":
        return torch.from_numpy(rng.normal(size=(5, 9, 9)).astype(np.float32))
    return {"sdf": torch.from_numpy(
                rng.normal(size=(2, 5, 5, 5)).astype(np.float32)),
            "voxel_colors": torch.from_numpy(
                rng.uniform(size=(2, 5, 5, 5, 3)).astype(np.float32))}


def _leaves(tree):
    return tree if isinstance(tree, dict) else {"": tree}


def _grads(tree, rng, scale):
    return (torch.from_numpy((rng.normal(size=tree.shape) * scale)
                             .astype(np.float32))
            if not isinstance(tree, dict) else
            {k: _grads(v, rng, scale) for k, v in tree.items()})


@pytest.mark.parametrize("kind", ["dict", "slab"])
def test_apply_is_update_then_apply_updates_on_cpu(kind):
    rng = np.random.default_rng(7)
    opt = adam(1e-2)
    p_a = p_b = _tree(kind, rng)
    s_a = s_b = opt.init(p_a)
    before = dict(ko.LAUNCHES)
    for step in range(4):
        g = _grads(p_a, rng, 10.0 ** -step)
        p_a, s_a = opt.apply(p_a, g, s_a)
        u, s_b = opt.update(g, s_b, p_b)
        p_b = apply_updates(p_b, u)
        assert type(p_a) is type(p_b)
        for x, y in ((p_a, p_b), (s_a.mu, s_b.mu), (s_a.nu, s_b.nu)):
            for k, v in _leaves(x).items():
                assert torch.equal(v, _leaves(y)[k]), (step, k)
        assert torch.equal(s_a.count, s_b.count)
    assert int(s_a.count) == 4
    assert ko.LAUNCHES == before


def test_apply_matches_optax():
    rng = np.random.default_rng(4)
    params = {"sdf": rng.normal(size=(2, 5, 5, 5)).astype(np.float32),
              "voxel_colors": rng.uniform(size=(2, 5, 5, 5, 3)).astype(
                  np.float32)}
    vopt, topt = optax.adam(1e-2), adam(1e-2)
    vp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    vs, ts = vopt.init(vp), topt.init(tp)
    for step in range(5):
        grads = {k: rng.normal(scale=10.0 ** -step, size=v.shape).astype(
            np.float32) for k, v in params.items()}
        vu, vs = vopt.update({k: jnp.asarray(g) for k, g in grads.items()},
                             vs, vp)
        vp = optax.apply_updates(vp, vu)
        tp, ts = topt.apply(tp, {k: torch.from_numpy(g)
                                 for k, g in grads.items()}, ts)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(vp[k]),
                                       rtol=1e-6)
            np.testing.assert_allclose(ts.mu[k].numpy(),
                                       np.asarray(vs[0].mu[k]), rtol=1e-6)
            np.testing.assert_allclose(ts.nu[k].numpy(),
                                       np.asarray(vs[0].nu[k]), rtol=1e-6,
                                       atol=1e-30)
    assert int(ts.count) == int(vs[0].count) == 5


@pytest.mark.parametrize("b1,b2", [(0.9, 0.999), (0.5, 0.95)])
def test_bias_corrections_equal_the_tensor_form(b1, b2):
    """``Adam.corrections`` against the form it replaced (the b's as f32
    tensors on the device, ``torch.tensor(b, device=...)``), bit for bit,
    elementwise over counts 0..10^4 - 1 and at the saturated count."""
    opt = adam(1e-2, b1, b2)
    top = toptim._COUNT_MAX
    counts = torch.cat([torch.arange(0, 10 ** 4, dtype=torch.int32),
                        torch.tensor([top - 1, top], dtype=torch.int32)])
    count, c1, c2 = opt.corrections(counts)
    want = counts + (counts < top).to(torch.int32)
    assert torch.equal(count, want)
    assert int(count[-1]) == int(count[-2]) == top
    steps = want.to(torch.float32)
    for b, c in ((b1, c1), (b2, c2)):
        old = 1 - torch.pow(torch.tensor(b, device=steps.device), steps)
        assert c.dtype == torch.float32
        assert torch.equal(c, old), (b, (c - old).abs().max())
    # the 0-d count a step carries
    count, c1, c2 = opt.corrections(torch.zeros((), dtype=torch.int32))
    assert count.shape == () and int(count) == 1
    # 1 - b at the first step, b rounded to f32 first
    assert float(c1) == pytest.approx(1 - b1, rel=1e-4)
    assert float(c2) == pytest.approx(1 - b2, rel=1e-4)


def test_sgd_apply_is_update_then_apply_updates():
    rng = np.random.default_rng(3)
    opt = sgd(1e-2)
    for kind in ("dict", "slab"):
        p = _tree(kind, rng)
        g = _grads(p, rng, 1.0)
        got, state = opt.apply(p, g, opt.init(p))
        want = apply_updates(p, opt.update(g, (), p)[0])
        assert state == ()
        for k, v in _leaves(got).items():
            assert torch.equal(v, _leaves(want)[k])


def test_apply_refuses_a_leaf_that_is_not_f32():
    opt = adam(1e-2)
    rng = np.random.default_rng(0)
    p = _tree("dict", rng)
    state = opt.init(p)
    g = _grads(p, rng, 1.0)
    before = dict(ko.LAUNCHES)
    for dtype in (torch.float64, torch.bfloat16, torch.float16):
        with pytest.raises(ValueError, match="f32"):
            opt.apply(dict(p, sdf=p["sdf"].to(dtype)), g, state)
        with pytest.raises(ValueError, match="f32"):
            opt.apply(p, dict(g, voxel_colors=g["voxel_colors"].to(dtype)),
                      state)
        with pytest.raises(ValueError, match="f32"):
            opt.apply(p, g, state._replace(
                nu=dict(state.nu, sdf=state.nu["sdf"].to(dtype))))
        with pytest.raises(ValueError, match="f32"):
            opt.apply(p["sdf"].to(dtype), g["sdf"], opt.init(p["sdf"]))
    # the kernel's wrapper refuses CPU tensors and launches nothing
    count, c1, c2 = opt.corrections(state.count)
    with pytest.raises(ValueError, match="CUDA"):
        ko.adam_step_cuda(p, g, state.mu, state.nu, c1, c2, 0.9, 0.999,
                          1e-2, 1e-8)
    assert ko.LAUNCHES == before


@pytest.mark.parametrize("case", ["fit_step", "view", "view_smooth"])
def test_fit_steps_through_apply_match_vrt(case):
    """Two steps of ``make_fit_step`` or ``make_fit_step_view`` (with
    ``sdf_smooth`` 0.3: ``update``, ``smooth3``, ``apply_updates``; without:
    ``apply``) on the flagship at resolution 3 with colours, 24x24, against
    vrt's jitted steps: losses to rtol 1e-4, parameters where the first
    step's gradient is at least 1e-3 of its largest to rtol 1e-4, atol 1e-5
    (``test_three_fit_steps_match_vrt``'s tolerances: Adam turns a
    near-zero gradient's rounding noise into a full step of either sign)."""
    vs = ge._flagship_scene(resolution=3, use_colors=True)
    ts = scene_from_numpy(scene_fields(vs), device="cpu")
    topt = adam(1e-2)
    calls = []
    for name in ("apply", "update"):
        method = getattr(topt, name)
        setattr(topt, name, lambda *a, _m=method, _n=name: (
            calls.append(_n), _m(*a))[1])
    cam = FIT_CAMS[0]
    target = np.full((24 * 24, 3), 0.25, np.float32)
    if case == "fit_step":
        vstep = vfit.make_fit_step(vs, FIT_CAMS, 24, 24, VMode(),
                                   optax.adam(1e-2))
        tstep = tfit.make_fit_step(ts, FIT_CAMS, 24, 24, RenderMode(), topt)
        vargs = (jnp.asarray(target[None]),)
        targs = (torch.from_numpy(target[None]),)
    else:
        kw = dict(sdf_smooth=0.3 if case == "view_smooth" else 0.0)
        vstep = vfit.make_fit_step_view(vs, 24, 24, VMode(),
                                        optax.adam(1e-2), **kw)
        tstep = tfit.make_fit_step_view(ts, 24, 24, RenderMode(), topt, **kw)
        vargs = (jnp.asarray(cam["position"]), jnp.asarray(cam["rotation"]),
                 jnp.asarray(cam["fov"]), jnp.asarray(target))
        targs = (torch.from_numpy(cam["position"]),
                 torch.from_numpy(cam["rotation"]),
                 torch.tensor(cam["fov"]), torch.from_numpy(target))
    vp = {"sdf": vs.volumes.sdf, "voxel_colors": vs.voxel_colors}
    tp = {"sdf": ts.volumes.sdf, "voxel_colors": ts.voxel_colors}
    vstate, tstate = optax.adam(1e-2).init(vp), topt.init(tp)
    _, g0 = tfit._value_and_grad(
        lambda p: torch.mean((tfit.render_views(
            tfit.graft_and_rebuild(ts, p), FIT_CAMS, 24, 24,
            RenderMode()) - 0.25) ** 2), tp)
    vl, tl = [], []
    for _ in range(2):
        vp, vstate, loss = vstep(vp, vstate, *vargs)
        vl.append(float(loss))
        tp, tstate, loss = tstep(tp, tstate, *targs)
        tl.append(float(loss))
    # on CPU tensors ``apply`` runs ``update`` itself
    assert calls == (["update"] if case == "view_smooth"
                     else ["apply", "update"]) * 2
    assert isinstance(tstate, AdamState) and int(tstate.count) == 2
    np.testing.assert_allclose(tl, vl, rtol=1e-4)
    for k in vp:
        g = np.abs(g0[k].numpy())
        big = g >= 1e-3 * g.max()
        assert big.sum() > 20, k
        np.testing.assert_allclose(tp[k].numpy()[big],
                                   np.asarray(vp[k])[big], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
