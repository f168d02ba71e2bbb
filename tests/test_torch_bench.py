"""``vrt_torch.apps.bench``, the port of ``vrt.apps.bench``, against
``vrt``'s on the CPU.

- the cells, their order and their labels are ``vrt``'s: ``vrt``'s ``main``
  runs with its ``bench_*`` functions replaced by recorders (config3's and
  config4's labels, which ``vrt`` forms inside its cells, come from those
  cells run at a small resolution with the timing and the frame replaced);
- config4's and config7's scenes and cameras, built by the app's
  ``config4_scene`` and ``config7_scene``, equal ``vrt``'s leaf by leaf at
  resolution 4, and config3's import through the app's own path equals
  ``vrt``'s at resolution 4 (from ``make_assets.torus_mesh``: nothing is
  downloaded);
- a 64x64 frame of config7 at resolution 6 against ``vrt``'s CPU render,
  the fixture ``tests/fixtures/config7_r6_64x64.npy`` (which
  ``chip_smoke.py`` holds the card against), at the f32 golden tolerances
  of tests/test_golden_full.py;
- config4's step at resolution 4 (bf16 corner table, per-voxel colours, 2
  views of 32x32, zero targets) against ``vrt``'s: the loss to rtol 1e-4
  and each gradient to a cosine within 1e-5 of 1 (measured: 2.6e-6 for
  the SDF, 9.6e-7 for the colours; ``vrt`` adds a bf16 table's cotangents
  in bf16, the port in f32 and casts once);
- ``--device cpu`` runs one cell end to end and writes the table.

Regenerate the fixture with ``JAX_PLATFORMS=cpu python -m
tests.test_torch_bench``.
"""

import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_render import assert_close_f32
from tests.test_torch_scene import assert_scene_equal
from vrt_torch.apps import bench

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "config7_r6_64x64.npy")
STEP_SIZE = 32
STEP_COS_TOL = 1e-5
CPU = torch.device("cpu")


def _record(calls, name):
    """A cell that records its name, its numbers and label and its frame
    size (not the results list, the device or ``vrt``'s chunk)."""
    def fn(*args, **kwargs):
        calls.append((name,) + tuple(
            a for a in args if isinstance(a, (int, str))
            and not isinstance(a, bool)) + tuple(sorted(
                (k, v) for k, v in kwargs.items() if k in ("width",
                                                           "height"))))
    return fn


def _vrt_cell_scenes(resolution=4):
    """``vrt``'s config3, config4 and config7 cells at ``resolution``, the
    timing and the frame (the fit step) replaced: {config: (label, scene,
    cameras or None)}."""
    import vrt.apps.bench as vb
    import vrt.render.renderer as vr

    seen = {}

    def frame(scene, width, height, mode, **kw):
        seen["scene"] = scene
        return jnp.zeros((height, width, 4))

    def fit(resolution, size, label, results, scene=None, cams=None, **kw):
        seen.update(label=label, scene=scene, cams=cams)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vb, "_time", lambda fn, iters=3: (fn(0), 1.0)[1])
        mp.setattr(vr, "render_image", frame)
        mp.setattr(vb, "bench_fit", fit)
        results = []
        vb.bench_voxelized_mesh(results, resolution=resolution)
        out[3] = (results[-1][0], seen.pop("scene"), None)
        vb.bench_many_instances(resolution, 32, bench.LABELS[7], results)
        out[7] = (results[-1][0], seen.pop("scene"), None)
        vb.bench_fit_257(results, resolution=resolution)
        out[4] = (seen["label"], seen["scene"], seen["cams"])
    return out


@pytest.fixture(scope="module")
def vrt_cells():
    return _vrt_cell_scenes()


def test_cells_order_and_labels_are_vrts(vrt_cells):
    """Both ``main``s over every config, listed backwards: the same cells
    with the same arguments and labels, in ``vrt``'s order."""
    import vrt.apps.bench as vb

    want, got = [], []
    names = ("bench_forward", "bench_voxelized_mesh", "bench_fit_257",
             "bench_fit", "bench_many_instances", "bench_scaling")
    every = ["--configs"] + [str(c) for c in reversed(bench.ORDER)]
    with pytest.MonkeyPatch.context() as mp:
        for name in names:
            mp.setattr(vb, name, _record(want, name))
            mp.setattr(bench, name, _record(got, name))
        vb.main(every)
        bench.main(every + ["--device", "cpu"])
    assert got == want
    assert len(got) == len(bench.ORDER) == 8
    assert vrt_cells[4][0] == bench.config4_label()
    assert vrt_cells[3][0] == bench.config3_label(17)
    assert bench.config3_label(257) == \
        "config3 voxelized glTF 257^3 1920x1080 fwd"


def test_config4_scene_and_cameras_equal_vrts(vrt_cells):
    _, vs, vcams = vrt_cells[4]
    ts, cams = bench.config4_scene(4, device="cpu")
    assert_scene_equal(ts, vs)
    assert ts.volumes.corners.dtype == torch.bfloat16
    assert ts.voxel_color_corners.dtype == torch.bfloat16
    assert len(cams) == len(vcams) == 2
    for c, v in zip(cams, vcams):
        assert sorted(c) == sorted(v)
        for k in c:
            np.testing.assert_array_equal(np.asarray(c[k], np.float32),
                                          np.asarray(v[k], np.float32), k)


def test_config7_scene_equals_vrts(vrt_cells):
    _, vs, _ = vrt_cells[7]
    ts = bench.config7_scene(4, device="cpu")
    assert_scene_equal(ts, vs)
    assert ts.num_instances == 12 and not ts.any_reflective


def test_config3_import_through_the_app_equals_vrts(vrt_cells, monkeypatch):
    """The app's config3 cell at resolution 4 (the import, ``build_scene``
    and the frame's scene) against ``vrt``'s cell's scene."""
    import vrt_torch.render.renderer as tr

    seen = {}
    monkeypatch.setattr(bench, "_time", lambda fn, device, iters=3:
                        (fn(), 1.0)[1])
    monkeypatch.setattr(tr, "render_image",
                        lambda scene, *a, **k: seen.setdefault("s", scene))
    results = []
    seconds = bench.bench_voxelized_mesh(results, CPU, resolution=4)
    assert set(seconds) == {"mesh", "convert", "load", "build"}
    label, vs, _ = vrt_cells[3]
    assert results[0][0] == label
    assert_scene_equal(seen["s"], vs)


def write_fixture(path=FIXTURE):
    """``vrt``'s CPU render of config7 at resolution 6, 64x64,
    ``RenderMode()``, RGB; saved to ``path`` unless it is None."""
    from vrt.render.gpuscene import RenderMode as VMode
    from vrt.render.renderer import render_image as vrender

    import vrt.apps.bench as vb
    import vrt.render.renderer as vr

    seen = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(vb, "_time", lambda fn, iters=3: (fn(0), 1.0)[1])
        mp.setattr(vr, "render_image",
                   lambda scene, *a, **k: seen.setdefault("s", scene))
        vb.bench_many_instances(6, 64, bench.LABELS[7], [])
    img = np.asarray(vrender(seen["s"], 64, 64, VMode()))[..., :3]
    if path is not None:
        np.save(path, img.astype(np.float32))
    return img


def test_config7_frame_matches_vrt():
    """The port's 64x64 config7 frame at resolution 6 against ``vrt``'s
    render (the fixture, ``write_fixture``'s)."""
    from vrt_torch.render.gpuscene import RenderMode
    from vrt_torch.render.renderer import render_image

    want = np.load(FIXTURE)
    assert want.shape == (64, 64, 3) and want.dtype == np.float32
    assert os.path.getsize(FIXTURE) < 100_000
    got = render_image(bench.config7_scene(6, device="cpu"), 64, 64,
                       RenderMode()).numpy()
    assert got.shape == (64, 64, 4) and np.isfinite(got).all()
    assert_close_f32(got[..., :3], want, "config7 r6 64x64 vs vrt")
    assert want.std() > 0.05


def test_config4_step_gradient_matches_vrt(vrt_cells):
    """config4's loss (zero targets, as the cell's) and gradients in the SDF
    and the colours at resolution 4, 2 views of 32x32, bf16 table."""
    vfit = importlib.import_module("vrt.diff.fit")
    from vrt.render.gpuscene import RenderMode as VMode
    from vrt_torch.diff import fit as tfit
    from vrt_torch.render.gpuscene import RenderMode

    _, vs, vcams = vrt_cells[4]
    ts, cams = bench.config4_scene(4, device="cpu")
    size = STEP_SIZE

    def vloss(p):
        s = vfit.rebuild_accel(vfit.graft_params(vs, p))
        return jnp.mean(vfit.render_views(s, vcams, size, size, VMode()) ** 2)

    value, vgrads = jax.jit(jax.value_and_grad(vloss))(
        {"sdf": vs.volumes.sdf, "voxel_colors": vs.voxel_colors})
    loss, grads = tfit._value_and_grad(
        lambda p: torch.mean(tfit.render_views(
            tfit.graft_and_rebuild(ts, p), cams, size, size,
            RenderMode()) ** 2), bench._fit_params(ts))
    assert float(loss) == pytest.approx(float(value), rel=1e-4)
    for k in ("sdf", "voxel_colors"):
        a = grads[k].double().numpy().ravel()
        b = np.asarray(vgrads[k], np.float64).ravel()
        assert np.abs(b).max() > 0, k
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        assert 1.0 - cos < STEP_COS_TOL, (k, 1.0 - cos)


def test_cli_runs_a_cell_on_the_cpu(tmp_path):
    """``main`` with ``--device cpu``: config5 end to end (one device:
    its frame time at an efficiency of 1.0) and the table under the
    device's title."""
    out = tmp_path / "BENCH.md"
    results = bench.main(["--configs", "5", "--device", "cpu", "--out",
                          str(out)])
    assert [r[0] for r in results] == [bench.LABELS[5]]
    assert results[0][1] > 0 and results[0][2] > 0
    text = out.read_text().splitlines()
    assert text[0] == "# vrt_torch benchmarks on cpu"
    assert text[2] == "| config | ms/frame | rays/s |"
    assert text[4].startswith(f"| {bench.LABELS[5]} | ")
    assert len(text) == 5


def test_scaling_over_two_ranks_on_the_cpu():
    """config5's sharded branch over two gloo ranks on the CPU at 16x16:
    an efficiency, and a row."""
    results = []
    eff = bench.bench_scaling(3, 16, bench.LABELS[5], results, CPU, n_dev=2)
    assert eff > 0 and len(results) == 1 and results[0][1] > 0


if __name__ == "__main__":
    write_fixture()
