"""The slab-sharded volume of ``vrt_torch.dist.brick`` against
``vrt.dist.brick`` (the sizes of tests/test_brick.py: resolution 5, 33^3).

- ``shard_volume`` gives ``vrt``'s arrays bit for bit at S = 2 and 4, and
  ``slab_from_numpy`` carries ``vrt``'s slabs across;
- the slab march's twin equals ``vrt``'s ``march_volume_slab`` on every
  shard: every integer field equal, t, the brackets and the face normal
  within the FMA allowance of the march tests (rtol 1e-4 on t; XLA's CPU
  backend contracts the cubic's sums into FMAs, the twin rounds each
  operation), NaN equal to NaN;
- ``combine_hits`` over gloo ranks equals ``vrt``'s under ``shard_map``;
- ``exchange_halos`` refreshes the halos after an edit;
- ``assemble_full_sdf`` and ``resync_slabs`` round-trip;
- with no hook the twin's loop gives ``march_lanes_reference``'s results
  of the tree before the hooks, bit for bit
  (``tests/fixtures/march_twin_r4_hooks_off.npz``, written by
  ``write_twin_fixture`` there);
- the slab resolve's closed-form backward into the planes
  (``resolve_slab_backward_reference`` on the default table) equals
  ``jax.grad`` of ``vrt``'s ``resolve_slab_hits`` in the planes and the
  rays, and the first design's table gradient carried to the planes by the
  pack's backward, within 1e-5 of the largest |g|; the ``table`` choice
  packs a corner table only for ``"packed"``.
"""

import dataclasses
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tests import torch_dist_workers as workers
from vrt.dist import brick as vbrick
from vrt.dist.mesh import make_render_mesh as vmesh
from vrt.volume import sdf as VS
from vrt.volume.volume import VoxelVolume as VVolume
from vrt_torch.dist import brick, mesh
from vrt_torch.march import march as tmarch
from vrt_torch.volume import sdf as TS
from vrt_torch.volume.volume import VoxelVolume as TVolume

torch.set_num_threads(2)
TIMEOUT = 240.0
TWIN_FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                            "march_twin_r4_hooks_off.npz")
CASES = ((True, False), (False, False), (True, True))


def _volumes(resolution=5):
    def build(S, Vol):
        csg = S.CSG(shape=S.Sphere(radius=55.0))
        csg.add_child(S.Box(extends=(70.0, 25.0, 25.0),
                            position=np.array([0.0, 0.0, 40.0], np.float32)),
                      S.ADD)
        return Vol.from_generator(csg, resolution, 100.0)
    return build(VS, VVolume), build(TS, TVolume)


def _rays(n=384, seed=3):
    """tests/test_brick.py's rays, a few with a zero direction component,
    a third with a finite t_max."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (-d * rng.uniform(150.0, 320.0, size=(n, 1))).astype(np.float32)
    o += rng.normal(scale=30.0, size=(n, 3)).astype(np.float32)
    d[::23, 1] = 0.0
    t_max = np.where(rng.uniform(size=n) < 0.3, 220.0, 1e4
                     ).astype(np.float32)
    return o, d, t_max


def _np_fields(slabs):
    return {f: np.asarray(getattr(slabs, f)) for f in brick._FIELDS}


def _assert_hits_close(got, want, tag):
    """MarchHits as numpy dicts: integer fields equal, floats within the
    FMA allowance, NaN equal to NaN."""
    for f in ("hit", "kind", "cell", "steps"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{tag} {f}")
    hit = want["hit"]
    np.testing.assert_allclose(got["t"][hit], want["t"][hit], rtol=1e-4,
                               err_msg=tag)
    assert np.array_equal(np.isinf(got["t"]), np.isinf(want["t"])), tag
    for f in ("t_in", "t_out"):
        np.testing.assert_allclose(got[f], want[f], rtol=1e-4, atol=1e-4,
                                   err_msg=f"{tag} {f}")
    np.testing.assert_allclose(got["face_normal"], want["face_normal"],
                               rtol=1e-6, equal_nan=True, err_msg=tag)


def _vrt_np(h):
    return {f: np.asarray(getattr(h, f)) for f in workers.HIT_FIELDS
            if getattr(h, f) is not None}


@pytest.mark.parametrize("s_count", [2, 4])
@pytest.mark.parametrize("accel_mode", ["octree", "chebyshev"])
def test_shard_volume_matches_vrt(s_count, accel_mode):
    vv, tv = _volumes()
    want = vbrick.shard_volume(vv, s_count, accel_mode=accel_mode)
    got = brick.shard_volume(tv, s_count, accel_mode=accel_mode)
    assert got.accel_mode == accel_mode and got.sdf.shape[0] == s_count
    for f in brick._FIELDS:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    # slab_from_numpy carries vrt's slabs across, and local() peels one
    back = brick.slab_from_numpy(_np_fields(want), accel_mode)
    for f in brick._FIELDS:
        np.testing.assert_array_equal(getattr(back, f).numpy(),
                                      getattr(got, f).numpy())
    one = got.local(s_count - 1, "cpu")
    assert one.sdf.shape == got.sdf.shape[1:] and one.n.dim() == 0
    assert int(one.cell_hi) == tv.n_voxels - 1


def test_shard_volume_refuses_an_uneven_split():
    with pytest.raises(ValueError):
        brick.shard_volume(_volumes(4)[1], 3)


@pytest.mark.parametrize("s_count", [2, 4])
@pytest.mark.parametrize("accel_mode", ["octree", "chebyshev"])
@pytest.mark.parametrize("interp,debug", CASES)
def test_slab_march_twin_matches_vrt(s_count, accel_mode, interp, debug):
    """The twin (``march_volume_slab`` on CPU tensors) against ``vrt``'s
    ``march_volume_slab`` on every shard."""
    vv, tv = _volumes()
    vs = vbrick.shard_volume(vv, s_count, accel_mode=accel_mode)
    ts = brick.shard_volume(tv, s_count, accel_mode=accel_mode)
    o, d, t_max = _rays()
    hits = 0
    for s in range(s_count):
        vslab = jax.tree.map(lambda x: x[s], vs)
        want = vbrick.march_volume_slab(vslab, jnp.asarray(o), jnp.asarray(d),
                                        jnp.asarray(t_max), interp=interp,
                                        debug_overlay=debug)
        got = brick.march_volume_slab(ts.local(s, "cpu"), torch.from_numpy(o),
                                      torch.from_numpy(d),
                                      torch.from_numpy(t_max), interp, debug)
        _assert_hits_close(workers._hit_np(got), _vrt_np(want),
                           f"shard {s}")
        hits += int(got.hit.sum())
    assert hits > 50


def test_owned_hits_only():
    """A shard reports surface hits in its own cells alone, and the shards'
    hits cover the replicated march's."""
    _, tv = _volumes()
    ts = brick.shard_volume(tv, 4)
    o, d, t_max = (torch.from_numpy(x) for x in _rays())
    for s in range(4):
        slab = ts.local(s, "cpu")
        h = brick.march_volume_slab_reference(slab, o, d, t_max)
        surf = h.kind == 1
        x = h.cell[surf, 0]
        assert bool(((x >= slab.cell_lo) & (x < slab.cell_hi)).all())


def test_hooks_off_twin_equals_the_twin_before_the_hooks():
    """``march_lanes_reference`` (the loop with every hook off) gives, bit
    for bit, what it gave before the hooks were added (the fixture)."""
    want = np.load(TWIN_FIXTURE)
    got = write_twin_fixture(None)
    assert sorted(got) == sorted(want.files)
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def write_twin_fixture(path=TWIN_FIXTURE):
    """``march_lanes_reference`` on the flagship at resolution 4 (octree
    and chebyshev, f32 and bf16 tables), 24x16 camera rays and 64 random
    lanes (every ninth with a zero y direction, every fifth with t_max
    150), in interp, cube, overlay and cube-overlay mode: every field, as
    numpy; saved to ``path`` unless it is None."""
    from vrt_torch.render.camera import camera_rays
    from vrt_torch.scenes import flagship_scene

    out = {}
    for accel in ("octree", "chebyshev"):
        for dtype in (torch.float32, torch.bfloat16):
            scene = flagship_scene(4, accel, dtype, device="cpu")
            o, d = camera_rays(scene.cam_pos, scene.cam_rot, scene.cam_fov,
                               24, 16)
            rng = np.random.default_rng(7)
            ro = torch.from_numpy(rng.uniform(-120, 120, (64, 3))
                                  .astype(np.float32))
            rd = torch.from_numpy(rng.normal(size=(64, 3))
                                  .astype(np.float32))
            rd[::9, 1] = 0.0
            o, d = torch.cat([o, ro]), torch.cat([d, rd])
            r = o.shape[0]
            vid = torch.from_numpy((np.arange(r) % 2).astype(np.int32))
            t_max = torch.full((r,), 1e4)
            t_max[::5] = 150.0
            for name, interp, dbg in (("interp", True, False),
                                      ("cube", False, False),
                                      ("overlay", True, True),
                                      ("cube_overlay", False, True)):
                h = tmarch.march_lanes_reference(scene.volumes, vid, o, d,
                                                 t_max, interp, dbg)
                key = f"{accel}_{str(dtype)[6:]}_{name}"
                for f in workers.HIT_FIELDS:
                    out[f"{key}/{f}"] = getattr(h, f).numpy()
    if path is not None:
        np.savez_compressed(path, **out)
    return out


def _vrt_combined(vs, s_count, o, d, t_max, interp, debug):
    m = vmesh(1, s_count)

    @partial(jax.shard_map, mesh=m, in_specs=(P("model"), P(), P(), P()),
             out_specs=P())
    def run(slabs, o, d, t_max):
        slab = jax.tree.map(lambda x: x[0], slabs)
        h = vbrick.march_volume_slab(slab, o, d, t_max, interp=interp,
                                     debug_overlay=debug)
        return vbrick.combine_hits(h, "model")

    return _vrt_np(jax.jit(run)(vs, jnp.asarray(o), jnp.asarray(d),
                                jnp.asarray(t_max)))


@pytest.mark.parametrize("s_count,accel_mode", [(4, "octree"),
                                                (2, "chebyshev")])
def test_combine_hits_matches_vrt(s_count, accel_mode):
    """Every gloo rank marches its slab and ``combine_hits`` joins them:
    every rank holds ``vrt``'s combined hits (integer fields equal, floats
    within the FMA allowance), which cover the replicated march's."""
    vv, tv = _volumes()
    vs = vbrick.shard_volume(vv, s_count, accel_mode=accel_mode)
    o, d, t_max = _rays()
    out = mesh.spawn_world(
        workers.combine_world, s_count,
        args=(_np_fields(vs), accel_mode, o, d, t_max, CASES),
        timeout=TIMEOUT)
    for (interp, debug), i in zip(CASES, range(len(CASES))):
        want = _vrt_combined(vs, s_count, o, d, t_max, interp, debug)
        for rank, got in enumerate(out):
            _assert_hits_close(got[i], want, f"rank {rank} case {i}")
            assert got[i]["hit"].dtype == np.bool_
        assert want["hit"].sum() > 100


def test_exchange_halos_after_an_edit():
    """Perturb every slab, exchange halos over 4 gloo ranks: each rank's
    halo planes equal its neighbours' owned planes at the same global x, the
    owned planes, the edge shards' planes outside the volume and the copy
    of plane cell_hi (owned by the next shard, refreshed by no exchange, as
    in ``vrt``) are kept, and a slab whose SDF requires a gradient gives
    the same planes and a graph (its gradient: tests/test_torch_dist_fit.py)."""
    _, tv = _volumes()
    slabs = brick.shard_volume(tv, 4)
    rng = np.random.default_rng(0)
    delta = rng.normal(scale=0.5, size=tuple(slabs.sdf.shape)
                       ).astype(np.float32)
    own = slabs.sdf.numpy() + delta
    out = mesh.spawn_world(workers.halo_world, 4,
                           args=(_np_fields(slabs), "octree", delta),
                           timeout=TIMEOUT)
    hl, span = brick.HALO, own.shape[1]
    for s, r in enumerate(out):
        assert r["graph"] and r["same"]
        got = r["sdf"]
        np.testing.assert_array_equal(got[hl:span - hl], own[s, hl:span - hl])
        left = own[s - 1, span - 2 * hl - 1:span - hl - 1] if s else \
            own[s, :hl]
        right = own[s + 1, hl + 1:2 * hl + 1] if s < 3 else own[s, span - hl:]
        np.testing.assert_array_equal(got[:hl], left)
        np.testing.assert_array_equal(got[span - hl:], right)


def test_exchange_halos_after_a_plane_edit_equals_a_fresh_split():
    """Edit one owned plane of rank 2 (global plane cell_lo + 1, in rank 1's
    right halo) and exchange halos: every rank's slab equals a fresh
    ``shard_volume`` of the edited volume."""
    _, tv = _volumes()
    slabs = brick.shard_volume(tv, 4)
    delta = np.zeros(tuple(slabs.sdf.shape), np.float32)
    delta[2, brick.HALO + 1] = np.random.default_rng(1).normal(
        scale=2.0, size=delta.shape[2:])
    out = mesh.spawn_world(workers.halo_world, 4,
                           args=(_np_fields(slabs), "octree", delta),
                           timeout=TIMEOUT)
    edited = tv.sdf.copy()
    edited[int(slabs.cell_lo[2]) + 1] += delta[2, brick.HALO + 1]
    fresh = brick.shard_volume(TVolume(tv.resolution, tv.extends,
                                       sdf=edited), 4)
    for s, r in enumerate(out):
        np.testing.assert_array_equal(r["sdf"], fresh.sdf[s].numpy())
    assert not np.array_equal(fresh.sdf[1].numpy(), slabs.sdf[1].numpy())


def test_assemble_full_sdf_round_trip():
    _, tv = _volumes()
    for s_count in (2, 4):
        full = brick.assemble_full_sdf(brick.shard_volume(tv, s_count))
        np.testing.assert_array_equal(full.numpy(), tv.sdf)


def test_resync_matches_fresh_shard_and_vrt():
    """Perturb the slabs, resync: equal to ``shard_volume`` of the
    assembled grid (accel, sdf, layout), and to ``vrt``'s resync of the same
    slabs."""
    vv, tv = _volumes()
    slabs = brick.shard_volume(tv, 4)
    rng = np.random.default_rng(11)
    bumped = slabs.sdf.numpy() + rng.normal(
        scale=3.0, size=tuple(slabs.sdf.shape)).astype(np.float32)
    slabs = dataclasses.replace(slabs, sdf=torch.from_numpy(bumped))
    got = brick.resync_slabs(slabs, tv.resolution)
    full = brick.assemble_full_sdf(slabs).numpy()
    fresh = brick.shard_volume(TVolume(tv.resolution, tv.extends, sdf=full),
                               4)
    vs = dataclasses.replace(vbrick.shard_volume(vv, 4),
                             sdf=jnp.asarray(bumped))
    want = vbrick.resync_slabs(vs, vv.resolution)
    for f in brick._FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(fresh, f).numpy(), err_msg=f)
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_assemble_and_resync_over_ranks():
    """Over 4 gloo ranks holding perturbed local slabs, ``assemble_full_sdf``
    gives every rank the grid of the stacked assembly, and ``resync_slabs``
    each rank its slab of the stacked resync."""
    _, tv = _volumes()
    slabs = brick.shard_volume(tv, 4)
    rng = np.random.default_rng(12)
    bumped = slabs.sdf.numpy() + rng.normal(
        scale=3.0, size=tuple(slabs.sdf.shape)).astype(np.float32)
    slabs = dataclasses.replace(slabs, sdf=torch.from_numpy(bumped))
    full = brick.assemble_full_sdf(slabs).numpy()
    want = brick.resync_slabs(slabs, tv.resolution)
    out = mesh.spawn_world(workers.resync_world, 4,
                           args=(_np_fields(slabs), tv.resolution),
                           timeout=TIMEOUT)
    for s, r in enumerate(out):
        np.testing.assert_array_equal(r["full"], full)
        np.testing.assert_array_equal(r["sdf"], want.sdf[s].numpy())
        np.testing.assert_array_equal(r["accel"], want.accel[s].numpy())


def test_resolve_slab_hits_matches_vrt():
    """``resolve_slab_hits`` on every shard's own hits against ``vrt``'s,
    on the owned hit lanes (the only lanes the tracer keeps)."""
    vv, tv = _volumes()
    vs, ts = vbrick.shard_volume(vv, 4), brick.shard_volume(tv, 4)
    o, d, t_max = _rays()
    jo, jd, jt = jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)
    to, td, tt = (torch.from_numpy(x) for x in (o, d, t_max))
    lanes = 0
    for s in range(4):
        vslab = jax.tree.map(lambda x: x[s], vs)
        slab = ts.local(s, "cpu")
        vh = vbrick.march_volume_slab(vslab, jo, jd, jt)
        th = brick.march_volume_slab(slab, to, td, tt)
        want = vbrick.resolve_slab_hits(vslab, jo, jd, vh)
        got = brick.resolve_slab_hits(slab, to, td, th)
        owned = th.hit.numpy()
        lanes += owned.sum()
        np.testing.assert_array_equal(got[2].numpy()[owned],
                                      np.asarray(want[2])[owned])
        np.testing.assert_allclose(got[0].numpy()[owned],
                                   np.asarray(want[0])[owned], rtol=1e-4)
        np.testing.assert_allclose(got[1].numpy()[owned],
                                   np.asarray(want[1])[owned], rtol=1e-3,
                                   atol=1e-4, equal_nan=True)
    assert lanes > 50


def test_slab_tables_pack_only_the_first_design():
    """A slab on its planes (the default) holds no corner table and
    resolves through its planes; ``table="packed"`` packs the table of the
    first design from them, ``pack_cell_corners``' rows; another name is
    refused."""
    _, tv = _volumes(4)
    slab = brick.shard_volume(tv, 2).local(1, "cpu")
    assert slab.table == "planes"
    assert "corners" not in slab.march_tables
    assert slab.resolve_table is slab.sdf
    packed = dataclasses.replace(slab, table="packed")
    corners = packed.march_tables["corners"]
    assert packed.resolve_table is corners
    span, nn = slab.sdf.shape[0], slab.sdf.shape[-1]
    assert corners.shape == (span - 1, nn - 1, nn - 1, 8)
    for j, (dx, dy, dz) in enumerate(brick.iso.CORNERS):
        assert torch.equal(corners[..., j],
                           slab.sdf[dx:dx + span - 1, dy:dy + nn - 1,
                                    dz:dz + nn - 1])
    stacked = brick.slab_from_numpy(_np_fields(brick.shard_volume(tv, 2)),
                                    table="packed")
    assert stacked.local(0, "cpu").table == "packed"
    with pytest.raises(ValueError, match="table"):
        dataclasses.replace(slab, table="rows")


def _closed_form_case(s_count, seed):
    """Every shard of ``_volumes()`` over ``s_count`` slabs with the port's
    hits of ``_rays()`` (object space = world space: ``default_fit_scene``'s
    instance is the identity) and random cotangents of t and the normal on
    the lanes the shard owns."""
    from vrt_torch.core import quat as vq
    from vrt_torch.dist.slab_render import default_fit_scene

    vv, tv = _volumes()
    light = np.asarray(vq.forward_vector(vq.from_euler_degrees(0, 45, -30)),
                       np.float32)
    scene = default_fit_scene(tv.n_voxels, tv.cell_size, tv.extends, light,
                              device="cpu")
    o, d, t_max = (torch.from_numpy(x) for x in _rays(n=1024, seed=seed))
    slabs = brick.shard_volume(tv, s_count)
    for s in range(s_count):
        slab = slabs.local(s, "cpu")
        hit = brick.march_volume_slab(slab, o, d, t_max)
        owned = (hit.hit & (hit.cell[:, 0] >= slab.cell_lo)
                 & (hit.cell[:, 0] < slab.cell_hi))
        gen = torch.Generator().manual_seed(seed + s)
        g_t = torch.randn(o.shape[0], generator=gen) * owned
        g_n = torch.randn(o.shape, generator=gen) * owned[:, None]
        yield scene, vbrick.shard_volume(vv, s_count), s, slab, o, d, hit, \
            owned, g_t, g_n


def _assert_within(got, want, tag, rtol=1e-5):
    scale = np.abs(want).max()
    assert scale > 0, tag
    assert np.abs(np.asarray(got, np.float64) - want).max() <= rtol * scale, \
        tag


def _on_a_cell_face(slab, o, d, hit):
    """Surface lanes whose hit point lies on a face of its cell (a
    coordinate of p exactly 0 or 1): there a trilinear weight |(1-i) - p|
    has a kink, whose derivative ``jnp.abs`` takes as 1, and so does the
    port (``core/kinks.py``)."""
    t0 = torch.where(torch.isfinite(hit.t), hit.t, 0.0)
    p = (o + d * t0[:, None]
         - (hit.cell.to(o.dtype) * slab.cell_size - slab.extends)) \
        / slab.cell_size
    return (hit.kind == 1) & ((p == 0.0) | (p == 1.0)).any(dim=-1)


@pytest.mark.parametrize("s_count", [2, 4])
def test_resolve_slab_closed_form_is_vrt_grad(s_count):
    """``resolve_slab_backward_reference`` into the planes against
    ``jax.grad`` of ``vrt.dist.brick.resolve_slab_hits`` (which reads the
    planes through ``_slab_fetch``) in the planes and the object-space
    rays, on the port's hits and the same cotangents, every shard, both in
    float64 (``jax.enable_x64``): within 1e-5 of the largest |g|.  In
    float32 the two round apart by up to ~1e-4 of it on lanes whose
    implicit-function term divides by a small F'(t0) (XLA's CPU backend
    contracts sums into FMAs), so the closed form's arithmetic is held to
    ``vrt``'s in float64.  Every owned lane is held, those too whose
    float32 hit point lies on a face of its cell (``_on_a_cell_face``; the
    next test holds them in float32, where the point is on the face)."""
    from vrt.march.types import MarchHit as VHit

    f64 = torch.float64
    lanes = faces = 0
    for scene, vslabs, s, slab, o, d, hit, owned, g_t, g_n in \
            _closed_form_case(s_count, 11):
        faces += int((owned & _on_a_cell_face(slab, o, d, hit)).sum())
        slab = dataclasses.replace(slab, sdf=slab.sdf.to(f64),
                                   cell_size=slab.cell_size.to(f64),
                                   extends=slab.extends.to(f64))
        o, d = o.to(f64), d.to(f64)
        hit = dataclasses.replace(hit, t=hit.t.to(f64))
        keep = owned
        g_t, g_n = (g_t * keep).to(f64), (g_n * keep[:, None]).to(f64)
        g_o, g_d, g_planes = brick.resolve_slab_backward_reference(
            scene, slab, o, d, hit, g_t, g_n, acc_dtype=f64)
        assert g_planes.shape == slab.sdf.shape
        with jax.enable_x64(True):
            vslab = jax.tree.map(lambda x: x[s], vslabs)
            vslab = dataclasses.replace(vslab, **{
                f: jnp.asarray(np.asarray(getattr(vslab, f)), jnp.float64)
                for f in ("sdf", "cell_size", "extends")})
            vhit = VHit(**{f: jnp.asarray(getattr(hit, f).numpy())
                           for f in workers.HIT_FIELDS})
            jg_t, jg_n = jnp.asarray(g_t.numpy()), jnp.asarray(g_n.numpy())

            def loss(sdf, jo, jd):
                t, n, _ = vbrick.resolve_slab_hits(
                    dataclasses.replace(vslab, sdf=sdf), jo, jd, vhit)
                return jnp.sum(t * jg_t) + jnp.sum(n * jg_n)

            want = jax.grad(loss, argnums=(0, 1, 2))(
                vslab.sdf, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
            want = [np.asarray(w) for w in want]
        assert want[0].dtype == np.float64
        for name, got, w in (("planes", g_planes, want[0]),
                             ("g_o", g_o, want[1]), ("g_d", g_d, want[2])):
            _assert_within(got.numpy(), w, (s_count, s, name))
        lanes += int(keep.sum())
    assert lanes > 50 and faces > 0


@pytest.mark.parametrize("s_count", [2, 4])
def test_resolve_slab_closed_form_is_vrt_grad_on_cell_faces(s_count):
    """The owned lanes whose hit point lies on a face of its cell in
    float32 (``_on_a_cell_face``; cast to float64 the point leaves the face,
    so the test above holds no such lane): the closed form, with cotangents
    on those lanes alone, against ``jax.grad`` of ``vrt``'s
    ``resolve_slab_hits`` in float32, every shard: a cosine within 1e-8 of
    1 and 1e-5 of the largest |g| in the planes and the rays.  ``vrt``
    takes d|a|/da as 1 at the kink; so does the port (torch's ``abs`` would
    take 0, and a cosine near 0.2)."""
    from vrt.march.types import MarchHit as VHit

    lanes = 0
    for scene, vslabs, s, slab, o, d, hit, owned, g_t, g_n in \
            _closed_form_case(s_count, 11):
        keep = owned & _on_a_cell_face(slab, o, d, hit)
        g_t, g_n = g_t * keep, g_n * keep[:, None]
        g_o, g_d, g_planes = brick.resolve_slab_backward_reference(
            scene, slab, o, d, hit, g_t, g_n)
        vslab = jax.tree.map(lambda x: x[s], vslabs)
        vhit = VHit(**{f: jnp.asarray(getattr(hit, f).numpy())
                       for f in workers.HIT_FIELDS})
        jg_t, jg_n = jnp.asarray(g_t.numpy()), jnp.asarray(g_n.numpy())

        def loss(sdf, jo, jd):
            t, n, _ = vbrick.resolve_slab_hits(
                dataclasses.replace(vslab, sdf=sdf), jo, jd, vhit)
            return jnp.sum(t * jg_t) + jnp.sum(n * jg_n)

        want = jax.grad(loss, argnums=(0, 1, 2))(
            vslab.sdf, jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
        for name, got, w in (("planes", g_planes, want[0]),
                             ("g_o", g_o, want[1]), ("g_d", g_d, want[2])):
            a = got.double().numpy().ravel()
            b = np.asarray(w, np.float64).ravel()
            cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
            assert 1.0 - cos < 1e-8, (s_count, s, name, 1.0 - cos)
            _assert_within(a, b, (s_count, s, name))
        lanes += int(keep.sum())
    assert lanes >= 20


@pytest.mark.parametrize("s_count", [2, 4])
def test_resolve_slab_closed_form_planes_equals_packed_through_the_pack(
        s_count):
    """The closed form into the planes against the first design's closed
    form into its packed table, carried to the planes by the backward of
    ``_pack_slab_corners`` (the step's autograd through the pack), in
    float32: within 1e-5 of the largest |g|; the ray gradients equal bit
    for bit (the same rows, the same arithmetic)."""
    lanes = 0
    for scene, _, s, slab, o, d, hit, owned, g_t, g_n in \
            _closed_form_case(s_count, 5):
        g_o, g_d, g_planes = brick.resolve_slab_backward_reference(
            scene, slab, o, d, hit, g_t, g_n)
        packed = dataclasses.replace(slab, table="packed")
        p_o, p_d, g_rows = brick.resolve_slab_backward_reference(
            scene, packed, o, d, hit, g_t, g_n)
        planes = slab.sdf.clone().requires_grad_(True)
        corners = brick._pack_slab_corners(planes)
        corners.backward(g_rows.reshape(corners.shape))
        _assert_within(g_planes.numpy(), planes.grad.double().numpy(),
                       (s_count, s))
        assert torch.equal(g_o, p_o) and torch.equal(g_d, p_d)
        lanes += int(owned.sum())
    assert lanes > 50


if __name__ == "__main__":
    write_twin_fixture()
