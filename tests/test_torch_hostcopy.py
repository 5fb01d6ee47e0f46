"""The port's own host modules (`dots_socp_torch.{config, utils, geometry,
models, data, cli, interface}`) against the JAX package's, of which they are
copies: the same input gives the same output, array for array. And the
port stands alone: a CLI solve in a fresh process imports neither jax nor
`dots_socp_tpu`."""

import logging
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import dots_socp_torch.cli as t_cli
import dots_socp_torch.config as t_config
import dots_socp_torch.interface as t_interface
import dots_socp_tpu.cli as j_cli
import dots_socp_tpu.config as j_config
import dots_socp_tpu.interface as j_interface
from dots_socp_torch.data import loader as t_loader
from dots_socp_torch.geometry import generators as t_gen
from dots_socp_torch.geometry import native as t_native
from dots_socp_torch.geometry import normalize as t_norm
from dots_socp_torch.geometry import surface as t_surf
from dots_socp_torch.models import cameras as t_cam
from dots_socp_torch.models import density as t_dens
from dots_socp_torch.models import registry as t_reg
from dots_socp_torch.utils import density as t_udens
from dots_socp_torch.utils import evaluate as t_eval
from dots_socp_torch.utils import history as t_hist
from dots_socp_tpu.data import loader as j_loader
from dots_socp_tpu.geometry import generators as j_gen
from dots_socp_tpu.geometry import native as j_native
from dots_socp_tpu.geometry import normalize as j_norm
from dots_socp_tpu.geometry import surface as j_surf
from dots_socp_tpu.models import cameras as j_cam
from dots_socp_tpu.models import density as j_dens
from dots_socp_tpu.models import registry as j_reg
from dots_socp_tpu.utils import density as j_udens
from dots_socp_tpu.utils import evaluate as j_eval
from dots_socp_tpu.utils import history as j_hist
from torch_rank_worker import ONE_THREAD_ENV

REPO = Path(__file__).resolve().parents[1]


def assert_same(a, b, path="value"):
    """Equality through dicts, sequences, arrays, sparse matrices, scalars."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for key in a:
            assert_same(a[key], b[key], f"{path}[{key!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif hasattr(a, "toarray"):
        assert (a != b).nnz == 0, path
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)
    else:
        assert a == b or (a != a and b != b), f"{path}: {a!r} != {b!r}"


def _plane(gen, n=12):
    vertices, triangles, edges = gen.generate_plane_mesh(n=n)
    return vertices, triangles, edges


def _surface(mod):
    vertices, triangles, _ = _plane(j_gen)
    area, angles, base = mod.triangle_quantities(vertices, triangles)
    v = vertices.shape[0]
    return {
        "area": area, "angles": angles, "base": base,
        "vertex_areas": mod.vertex_areas(triangles, area, v),
        "laplacian": mod.cotan_laplacian(triangles, angles, v),
    }


def _partition(mod):
    _, triangles, _ = _plane(j_gen, 16)
    v = int(triangles.max()) + 1
    return [mod.bfs_partition(triangles, v, parts) for parts in (2, 3, 4)]


def _normalize(mod):
    _, geometry, _ = j_loader.load_example("plane", kwargs_generating_mesh={"n": 12})
    normalized, scale = mod.normalize_geometry(geometry)
    return dict(normalized), scale


def _generators(mod):
    return {
        "plane": mod.generate_plane_mesh(n=9),
        "sphere": mod.generate_sphere_mesh(),
        "torus": mod.generate_torus_mesh(n_u=12, n_v=8),
        "knot": mod.generate_knot_mesh(p=2, q=3),
        "hills": mod.generate_hills_mesh(n=10),
    }


def _densities(mod):
    vertices, _, _ = _plane(j_gen)
    return {
        "gaussian": mod.gaussian(vertices, np.array([0.3, 0.4, 0.0]), 0.1),
        "radial_mask": mod.radial_mask(vertices, np.array([0.5, 0.5, 0.0]), 0.3),
        "cut_off": mod.cut_off(np.linspace(-1, 1, 41), 0.2),
    }


def _norms(mod):
    rng = np.random.default_rng(0)
    v, w = rng.standard_normal((5, 30)), rng.random(30)
    return [mod.l1_norm(v, w), mod.l2_norm(v, w), mod.linf_norm(v), mod.l1_norm(v), mod.l2_norm(v)]


def _evaluate(mod):
    rng = np.random.default_rng(1)
    mu = rng.random((6, 40))
    mu /= mu.sum(axis=1, keepdims=True)
    mu[2, 3] = -1e-3
    return [mod.check_mass_conservation(mu, verbose=False), mod.check_negative_mass(mu, verbose=False)]


def _history(mod):
    """A RunningHistory fed a fixed sequence of records, an overwrite of the
    last one and step times; everything it holds but the wall clock."""
    hist = mod.RunningHistory(8, ["a", "b", "c"], "test", kkt_short_labels=["A", "B", "C"])
    hist.start()
    for it, errs in [(0, [1.0, 0.5, 0.2]), (3, [0.1, 0.05, 0.02]), (3, [0.09, 0.04, 0.01]),
                     (7, [1e-3, 1e-4, np.nan])]:
        hist.record(current_it=it, kkt_errors=errs, history={"Objective value": 1.0 / (1 + it)})
    hist.add_step_time("phi", 0.25)
    hist.add_step_time("phi", 0.5)
    hist.end()
    with pytest.raises(ValueError):
        hist.record(current_it=2, kkt_errors=[0, 0, 0])
    return {
        "kkt_errors": hist.kkt_errors, "kkt_iteration": hist.kkt_iteration, "history": hist.history,
        "steps_time": hist.steps_time, "current": hist.get_current_kkt_errors(),
        "labels": [hist.kkt_labels, hist.kkt_short_labels, hist.name],
    }


def _registry(mod):
    """Every example's mesh (by file name, or its surrogate's generator) and
    settings module (by name)."""
    out = {}
    for name in mod.EXAMPLE_NAMES:
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mesh, setting = mod.match_example(name)
        mesh_id = Path(mesh).name if isinstance(mesh, (str, Path)) else (
            mesh.generator, sorted(mesh.kwargs.items()), mesh.surrogate_for)
        out[name] = (mesh_id, setting.__name__.rsplit(".", 1)[-1])
    return out


IDENTITY_CASES = {
    "surface": (_surface, j_surf, t_surf),
    "bfs_partition": (_partition, j_native, t_native),
    "normalize_geometry": (_normalize, j_norm, t_norm),
    "generators": (_generators, j_gen, t_gen),
    "model_densities": (_densities, j_dens, t_dens),
    "density_norms": (_norms, j_udens, t_udens),
    "evaluate": (_evaluate, j_eval, t_eval),
    "running_history": (_history, j_hist, t_hist),
    "registry": (_registry, j_reg, t_reg),
    "cameras": (lambda mod: [mod.get_camera(n) for n in ("plane", "bunny", "sphere", "nope")],
                j_cam, t_cam),
}


@pytest.mark.parametrize("case", sorted(IDENTITY_CASES))
def test_copied_module_gives_what_the_original_gives(case):
    fn, original, copy = IDENTITY_CASES[case]
    assert copy.__name__.startswith("dots_socp_torch.") and original.__name__.startswith("dots_socp_tpu.")
    assert_same(fn(copy), fn(original), case)


@pytest.mark.parametrize("example, n", [("plane", 12), ("plane", 30), ("sphere", None), ("ring", None)])
def test_load_example_equal_array_for_array(example, n):
    """load_example: the name, every array of the geometry and the camera.
    `sphere` reads its stored densities from the shared data directory
    through the port's own path_config.toml."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # surrogate-mesh notices
        ref = j_loader.load_example(example, kwargs_generating_mesh={"n": n})
        port = t_loader.load_example(example, kwargs_generating_mesh={"n": n})
    assert_same([port[0], dict(port[1]), port[2]], [ref[0], dict(ref[1]), ref[2]], example)


ARGVS = [
    [],
    ["--example", "plane", "--n_space", "40"],
    ["--example", "bunny", "--ntime", "15", "--tol", "1e-4", "--nit", "250", "--tau", "1.5",
     "--congestion", "0.05", "--eps", "1e-6", "--time_limit", "90"],
    ["--mesh_file", "m.off", "--setting_file", "s.py", "--precision", "float64",
     "--laplacian_mode", "cg", "--phi_refine", "on"],
    ["--save", "--show_kkt", "--save_kkt_time", "-o", "out/x", "--log_file", "x.log",
     "--cmap", "viridis", "--power_perceptual", "0.5", "--detail_runhist"],
    ["--mesh_shape", "1x4", "--coordinator_address", "localhost:1234", "--num_processes", "4",
     "--process_id", "2"],
    ["--log_level", "kkt", "--versus_exact", "--checkpoints", "1e-2", "1e-3",
     "--sigma_freeze_error", "2e-3", "--snapshot", "s.npz", "--snapshot_every", "60",
     "--profile_dir", "prof", "--pad_multiple", "16", "--max_dense_vertices", "9000"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a[:2]) or "defaults" for a in ARGVS])
def test_parse_args_equal(argv):
    """The port's parser reads every argument vector as the JAX package's
    does, and adds only --device and --dist_backend."""
    ref = vars(j_cli.parse_args(return_parser=True).parse_args(argv))
    port = vars(t_cli.parse_args(return_parser=True).parse_args(argv))
    assert sorted(set(port) - set(ref)) == ["device", "dist_backend"]
    assert port["device"] == "cuda" and port["dist_backend"] is None
    assert_same({k: port[k] for k in ref}, ref)


@pytest.mark.parametrize("argv", [["--tau", "2.5"], ["--power_perceptual", "0"], ["--precision", "bf16"]])
def test_parse_args_rejects_alike(argv):
    for mod in (j_cli, t_cli):
        with pytest.raises(SystemExit):
            mod.parse_args(return_parser=True).parse_args(argv)


def test_config_equal():
    """The same log levels and the same path keys; the data directories are
    the JAX package's own (read where they lie), the settings the port's."""
    assert t_config.LOG_LEVELS == j_config.LOG_LEVELS
    assert sorted(t_config.PATHS) == sorted(j_config.PATHS)
    for key in ("mesh_dir", "camera_dir", "mu_data_dir"):
        assert os.path.realpath(t_config.PATHS[key]) == os.path.realpath(j_config.PATHS[key])
    assert Path(t_config.PATHS["setting_dir"]) == Path(t_config.__file__).parents[1] / "models" / "examples"
    assert logging.getLevelName(t_config.LOG_LEVELS["kkt"]) == "KKT"


def test_interface_validates_and_maps_alike():
    """The interface's option map and validation are the original's; the
    port's refuses a mesh in opts (its CLI binds the mesh into the solver
    instead of handing it to JAX)."""
    from argparse import Namespace

    assert t_interface._KEY_MAPPING == j_interface._KEY_MAPPING
    bad = [dict(ntime=0), dict(ntime=5), dict(ntime=5, example="plane", tau=3.0),
           dict(ntime=5, example="plane", checkpoints=[2.0])]
    for kw in bad:
        for mod in (j_interface, t_interface):
            with pytest.raises(ValueError):
                mod._validate_opts(Namespace(**kw))
    for mod in (j_interface, t_interface):
        mod._validate_opts(Namespace(ntime=5, example="plane", tau=1.5, tol=1e-3))
    opts = Namespace(ntime=3, example="plane", n_space=6, mesh_shape="1x2")
    with pytest.raises(ValueError, match="mesh_shape"):
        t_interface.run_dot_surface(opts, solver=lambda *a, **k: None)


SWEEP_LOG = """\
2026-01-05 10:00:00,123 ---- Info: Experiment Setting -------------
example: ring
congestion: 0.01
2026-01-05 10:00:00,200 ---- Discretization ----------------------
Example name: ring
Number of points in time: 31
Number of vertices: 3072
Number of triangles: 6144
2026-01-05 10:00:09,000 Transportation cost: 9.803123e-01
Time of steps                         :    8.31 sec (95.58%)
Total Iteration                       :     412 iterations
2026-01-05 10:00:09,100 Converged: yes
2026-01-05 10:00:10,000 ---- Info: Experiment Setting -------------
example: hills
2026-01-05 10:00:10,100 Example name: hills
Number of vertices: 11716
Number of triangles: 23040
Transportation cost: 1.250000e+00
Time of steps                         :   30.02 sec (99.00%)
Total Iteration (l.l.)                :     999 iterations
Converged: time-capped
2026-01-05 10:01:00,000 ---- Info: Experiment Setting -------------
Example name: broken_block
"""


def test_log2table_copy_gives_what_the_original_gives(tmp_path):
    """The port's copy of replication/log2table.py: the same records from
    the same log (time stamps stripped, the optional Converged column, an
    incomplete block dropped with a warning) and the same exported files."""
    import importlib.util

    from dots_socp_torch.replication import log2table as t_l2t

    spec = importlib.util.spec_from_file_location("orig_log2table_copycheck",
                                                  REPO / "replication" / "log2table.py")
    j_l2t = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(j_l2t)
    log = tmp_path / "info.log"
    log.write_text(SWEEP_LOG)
    with pytest.warns(UserWarning, match="incomplete experiment block"):
        records = t_l2t.parse_log(str(log))
    with pytest.warns(UserWarning, match="incomplete experiment block"):
        assert records == j_l2t.parse_log(str(log))
    assert [r["Example"] for r in records] == ["ring", "hills"]
    assert [r["Converged"] for r in records] == ["yes", "time-capped"]
    assert t_l2t.FIELDS == j_l2t.FIELDS and t_l2t.OPTIONAL_FIELDS == j_l2t.OPTIONAL_FIELDS
    for mod, tag in ((t_l2t, "port"), (j_l2t, "orig")):
        with pytest.warns(UserWarning):
            mod.log2table(str(log), [str(tmp_path / f"{tag}.{ext}") for ext in ("csv", "tex", "html")])
    for ext in ("csv", "tex", "html"):
        assert (tmp_path / f"port.{ext}").read_text() == (tmp_path / f"orig.{ext}").read_text()


def test_cli_solve_imports_neither_jax_nor_the_jax_package(tmp_path):
    """A fresh process imports the port, its CLI and its interface, runs a
    plane n=12, T=7 solve on the CPU through the CLI's `main`, and ends with
    no module of jax or of dots_socp_tpu in sys.modules."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import dots_socp_torch, dots_socp_torch.cli, dots_socp_torch.interface\n"
        "solution, geometry, history = dots_socp_torch.cli.main([\n"
        "    '--example', 'plane', '--n_space', '12', '--ntime', '7', '--tol', '1e-3',\n"
        "    '--nit', '300', '--precision', 'float64', '--device', 'cpu'])\n"
        "assert solution['mu'].shape == (8, geometry['vertices'].shape[0])\n"
        "kkt = history.kkt_errors[np.isfinite(history.kkt_iteration)]\n"
        "assert np.isfinite(kkt).any() and np.nanmax(kkt[-1]) < 1e-2, kkt[-1]\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'dots_socp_tpu'))\n"
        "assert not bad, bad\n"
        "print('IMPORTS_CLEAN')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), **ONE_THREAD_ENV)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "IMPORTS_CLEAN" in proc.stdout
