# The port's own copy of dots_socp_tpu/utils/show.py; only the import paths differ.
"""Visualization: density normalization + PyVista rendering (optional).

Functional parity with reference `utils/show.py:28-494`. The density
normalization math (perceptual power transform, clim scaling) is always
available; rendering requires pyvista/imageio, which are optional extras --
when absent, rendering entry points raise a clear ImportError while the rest
of the framework (solve, evaluate, tables) works fully.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from dots_socp_torch.config import LOG_LEVELS
from dots_socp_torch.utils.density import translate_density
from dots_socp_torch.utils.types import GeometryData

AVAILABLE_COLORMAPS = ["bone_r", "gist_heat_r", "GnBu", "YlGnBu", "Blues"]
DEFAULT_CMAP_SAVE = AVAILABLE_COLORMAPS[0]
DEFAULT_CMAP_SHOW = AVAILABLE_COLORMAPS[2]
CLIM_MAX = 1.0


def _require_pyvista():
    try:
        import pyvista as pv  # noqa: F401

        return pv
    except ImportError as exc:  # pragma: no cover
        raise ImportError(
            "Visualization requires the optional 'pyvista' package "
            "(pip install pyvista imageio). Solving, evaluation and table "
            "export do not need it."
        ) from exc


def _has_pyvista() -> bool:
    try:
        import pyvista  # noqa: F401

        return True
    except ImportError:
        return False


class MplMesh:
    """Minimal mesh holder for the matplotlib fallback renderer (used when
    pyvista is not installed; interactive `--show` still needs pyvista)."""

    def __init__(self, vertices, triangles):
        self.vertices = np.asarray(vertices, dtype=float)
        self.triangles = np.asarray(triangles, dtype=np.int64)


def _render_mesh_matplotlib(
    mesh: "MplMesh",
    scalar_data=None,
    title=None,
    save_path=None,
    cmap=None,
    camera_config=None,
    window_size=(1200, 1200),
):
    """Static-frame renderer on matplotlib's 3D toolkit: per-triangle flat
    shading of the density (mean of corner values), camera angles derived
    from the pyvista camera configs."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    from matplotlib import colormaps
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    if isinstance(camera_config, list):
        base = Path(save_path)
        paths = []
        for idx, cfg in enumerate(camera_config):
            camera_id = cfg.get("name") or f"camera_{idx:02d}"
            out = base.parent / f"{base.stem}_{camera_id}{base.suffix}"
            _render_mesh_matplotlib(
                mesh, scalar_data, title, out, cmap, cfg, window_size
            )
            paths.append(out)
        return paths

    v, t = mesh.vertices, mesh.triangles
    polys = v[t]  # (F, 3, 3)
    fig = plt.figure(
        figsize=(window_size[0] / 120, window_size[1] / 120), dpi=120
    )
    ax = fig.add_subplot(projection="3d")
    if scalar_data is not None:
        tri_vals = np.asarray(scalar_data)[t].mean(axis=1)
        colors = colormaps[cmap or DEFAULT_CMAP_SAVE](
            np.clip(tri_vals / CLIM_MAX, 0.0, 1.0)
        )
        collection = Poly3DCollection(polys, facecolors=colors, edgecolor="none")
    else:
        collection = Poly3DCollection(
            polys, facecolors="white", edgecolor="0.6", linewidths=0.2
        )
    ax.add_collection3d(collection)

    lo, hi = v.min(axis=0), v.max(axis=0)
    center, half = (lo + hi) / 2, (hi - lo).max() / 2 or 1.0
    ax.set_xlim(center[0] - half, center[0] + half)
    ax.set_ylim(center[1] - half, center[1] + half)
    ax.set_zlim(center[2] - half, center[2] + half)
    ax.set_axis_off()
    ax.set_box_aspect((1, 1, 1))

    if camera_config is not None:
        d = np.asarray(camera_config["position"]) - np.asarray(
            camera_config["focal_point"]
        )
        r = np.linalg.norm(d) or 1.0
        ax.view_init(
            elev=float(np.degrees(np.arcsin(np.clip(d[2] / r, -1, 1)))),
            azim=float(np.degrees(np.arctan2(d[1], d[0]))),
        )
    if title:
        ax.set_title(title)
    fig.savefig(save_path, bbox_inches="tight", facecolor="white")
    plt.close(fig)
    return save_path


# -----------------------------------------------------------------------------
# Density normalization (always available)
# -----------------------------------------------------------------------------
def decorator_factory_power_perceptual(power: float = None):
    """Apply a power-law perceptual transform to plotted densities."""
    if power is None:
        power = 1.0

    def apply_power(data: np.ndarray) -> np.ndarray:
        return CLIM_MAX * np.power(np.maximum(data, 0.0), power) / CLIM_MAX**power

    def decorator(func):
        def wrapper(*args, **kwargs):
            return tuple(apply_power(r) for r in func(*args, **kwargs))

        return wrapper

    return decorator


def normalize_density_to_plot(mu: np.ndarray, geometry: GeometryData):
    """Scale (mu, mu0, mu1) densities jointly so the boundary max maps to
    CLIM_MAX."""
    mu_n = translate_density(mu, geometry)
    mu0_n = translate_density(np.asarray(geometry["mu0"]), geometry)
    mu1_n = translate_density(np.asarray(geometry["mu1"]), geometry)
    max_val = max(np.max(mu0_n), np.max(mu1_n))
    clip = lambda x: np.clip(CLIM_MAX / max_val * x, -np.inf, CLIM_MAX)
    return clip(mu_n), clip(mu0_n), clip(mu1_n)


def normalize_density_to_plot2(mu: np.ndarray, geometry: GeometryData):
    """Per-time-slice normalization variant: every slice maps to [0, 1]."""
    def per_slice(data):
        if data.ndim == 1:
            return data / np.max(data)
        return CLIM_MAX * data / np.max(data, axis=1, keepdims=True)

    return (
        per_slice(translate_density(mu, geometry)),
        per_slice(translate_density(np.asarray(geometry["mu0"]), geometry)),
        per_slice(translate_density(np.asarray(geometry["mu1"]), geometry)),
    )


# -----------------------------------------------------------------------------
# PyVista rendering (optional extra)
# -----------------------------------------------------------------------------
def create_pv_mesh(vertices, triangles):
    """Renderable mesh: a pyvista PolyData, or the matplotlib-fallback
    MplMesh when pyvista is not installed (static saves keep working)."""
    if not _has_pyvista():
        return MplMesh(vertices, triangles)
    pv = _require_pyvista()
    faces = np.column_stack(
        (np.full(triangles.shape[0], 3, dtype=np.int64), triangles)
    )
    return pv.PolyData(vertices, faces.flatten())


def set_camera_with_config(plotter, camera_config):
    pv = _require_pyvista()
    if camera_config is None:
        plotter.view_isometric()
        return
    cfg = camera_config[0] if isinstance(camera_config, list) else camera_config
    camera = pv.Camera()
    camera.position = cfg["position"]
    camera.focal_point = cfg["focal_point"]
    camera.up = cfg["up"]
    plotter.camera = camera


def _build_plotter(
    mesh,
    scalar_data=None,
    title=None,
    show=False,
    cmap=DEFAULT_CMAP_SAVE,
    background_color="white",
    window_size=(1200, 1200),
):
    pv = _require_pyvista()
    opts = {
        "smooth_shading": True,
        "specular": 0.5,
        "specular_power": 15,
        "show_scalar_bar": False,
    }
    plotter = pv.Plotter(window_size=window_size, off_screen=not show)
    plotter.background_color = background_color
    if scalar_data is not None:
        mesh["values"] = scalar_data
        plotter.add_mesh(
            mesh,
            scalars="values",
            show_edges=False,
            cmap=cmap or DEFAULT_CMAP_SAVE,
            clim=[0.0, CLIM_MAX],
            **opts,
        )
    else:
        plotter.add_mesh(mesh, color="white", show_edges=True, line_width=0.5, **opts)
    if title:
        plotter.add_text(title, font_size=14, position="upper_edge")
    return plotter


def render_mesh(
    mesh,
    scalar_data=None,
    title=None,
    show=False,
    save_path=None,
    cmap=None,
    camera_config=None,
    background_color="white",
    window_size=(1200, 1200),
):
    """Render one frame: to screen (show=True) or to an image file.

    With a list of camera configs, one image per camera is written with the
    camera name appended to the file stem; the list of paths is returned.
    """
    if show and save_path:
        raise ValueError("choose either show or save_path")
    if not show and not save_path:
        raise ValueError("one of show / save_path is required")

    if isinstance(mesh, MplMesh):
        if show:
            raise ImportError(
                "Interactive viewing requires pyvista; static --save output "
                "uses the matplotlib fallback."
            )
        return _render_mesh_matplotlib(
            mesh,
            scalar_data=scalar_data,
            title=title,
            save_path=save_path,
            cmap=cmap,
            camera_config=camera_config,
            window_size=window_size,
        )

    kwargs = dict(
        mesh=mesh,
        scalar_data=scalar_data,
        title=title,
        show=show,
        cmap=cmap,
        background_color=background_color,
        window_size=window_size,
    )
    if show:
        plotter = _build_plotter(**kwargs)
        set_camera_with_config(plotter, camera_config)
        plotter.show()
        plotter.close()
        return None

    if isinstance(camera_config, list):
        base = Path(save_path)
        paths = []
        for idx, cfg in enumerate(camera_config):
            camera_id = cfg.get("name") or f"camera_{idx:02d}"
            out = base.parent / f"{base.stem}_{camera_id}{base.suffix}"
            plotter = _build_plotter(**kwargs)
            set_camera_with_config(plotter, cfg)
            plotter.screenshot(out, transparent_background=False, return_img=False)
            plotter.close()
            paths.append(out)
        return paths

    plotter = _build_plotter(**kwargs)
    set_camera_with_config(plotter, camera_config)
    plotter.screenshot(save_path, transparent_background=False, return_img=False)
    plotter.close()
    return save_path


def save_description_of_dot(
    mesh, mu0, mu1, filename_format_example, camera_config=None, cmap=None
):
    """Save mesh-structure, initial-density and final-density stills."""
    cmap = cmap or DEFAULT_CMAP_SAVE
    render_mesh(
        mesh,
        None,
        save_path=filename_format_example.format(description="mesh"),
        camera_config=camera_config,
    )
    for tag, data in (("mu0", mu0), ("mu1", mu1)):
        render_mesh(
            mesh,
            data,
            save_path=filename_format_example.format(description=tag),
            camera_config=camera_config,
            cmap=cmap,
        )


def save_results_of_dot(
    mesh, mu, filename_format_animation, num_frames=5, camera_config=None, cmap=None
):
    """Save `num_frames` evenly spaced stills of the density evolution."""
    cmap = cmap or DEFAULT_CMAP_SAVE
    n_time = mu.shape[0]
    frames = [int(i * (n_time - 1) / (num_frames - 1)) for i in range(num_frames)]
    for i in frames:
        render_mesh(
            mesh,
            mu[i, :],
            save_path=filename_format_animation.format(time_frame_number=i + 1),
            camera_config=camera_config,
            cmap=cmap,
        )


def save_animation(
    mesh,
    to_plot,
    animation_filename: str,
    window_size=(1200, 1200),
    camera_config=None,
    cmap=None,
):
    """Write the full density-evolution animation as an mp4 (per camera).

    Without imageio the rendered PNG frames are kept on disk instead of
    being assembled (and a notice logged)."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        imageio = None

    cmap = cmap or DEFAULT_CMAP_SAVE
    temp_dir = Path(animation_filename).parent / "temp_frames"
    temp_dir.mkdir(exist_ok=True)
    n_time = to_plot.shape[0]

    logging.log(LOG_LEVELS["info"], "Generating animation frames...")
    frame_files = []
    for idx in range(n_time):
        saved = render_mesh(
            mesh,
            to_plot[idx, :],
            save_path=temp_dir / f"frame_{idx:04d}.png",
            camera_config=camera_config,
            window_size=window_size,
            cmap=cmap,
        )
        frame_files.append(saved)
        if (idx + 1) % 5 == 0 or idx == n_time - 1:
            logging.log(LOG_LEVELS["info"], f"Generated {idx + 1}/{n_time} frames")

    if imageio is None:
        logging.log(
            LOG_LEVELS["info"],
            f"imageio not installed: keeping {len(frame_files)} animation "
            f"frames in {temp_dir} instead of assembling "
            f"{animation_filename}",
        )
        return

    def write(filename, files):
        logging.log(LOG_LEVELS["info"], f"Creating animation at {filename}...")
        try:
            writer = imageio.get_writer(filename, fps=10)
        except (ValueError, ImportError):
            # No mp4 backend (ffmpeg/pyav): fall back to an animated GIF.
            gif = Path(filename).with_suffix(".gif")
            logging.log(
                LOG_LEVELS["info"],
                f"No mp4 backend available; writing {gif} instead",
            )
            try:
                writer = imageio.get_writer(gif, fps=10)
            except (ValueError, ImportError):
                logging.log(
                    LOG_LEVELS["info"],
                    f"No animation backend at all; keeping frames in {temp_dir}",
                )
                return False
        for file in files:
            writer.append_data(imageio.imread(file))
        writer.close()
        return True

    if isinstance(frame_files[0], list):  # multiple cameras
        per_camera = list(map(list, zip(*frame_files)))
        base = Path(animation_filename)
        ok = True
        for idx, files in enumerate(per_camera):
            cfg = camera_config[idx] if isinstance(camera_config, list) else {}
            camera_id = cfg.get("name") or f"camera_{idx:02d}"
            ok = (
                write(base.parent / f"{base.stem}_{camera_id}{base.suffix}", files)
                and ok
            )
        flat = [f for files in per_camera for f in files]
    else:
        ok = write(animation_filename, frame_files)
        flat = frame_files
    if not ok:  # keep the frames as the deliverable
        return

    for file in flat:
        try:
            Path(file).unlink()
        except OSError as exc:  # pragma: no cover
            logging.warning(f"Could not remove temp file {file}: {exc}")
    try:
        temp_dir.rmdir()
    except OSError as exc:  # pragma: no cover
        logging.warning(f"Could not remove temp directory {temp_dir}: {exc}")
    logging.log(LOG_LEVELS["info"], "Animation created successfully")


def show_animation(
    mesh,
    to_plot,
    example_name: str = None,
    window_size=(1200, 1200),
    camera_config=None,
    cmap=None,
):
    """Interactive transport viewer.

    Controls: arrow keys step through time, Space toggles autoplay,
    Home/End jump to the first/last time step, a full-width frame slider
    scrubs, Q quits. (The reference also ships an interactive viewer,
    `utils/show.py:317-424`; this widget design -- autoplay, frame-indexed
    slider, HUD readout -- is this framework's own.)
    """
    pv = _require_pyvista()
    cmap = cmap or DEFAULT_CMAP_SHOW
    n_time = to_plot.shape[0]
    logging.log(
        LOG_LEVELS["info"],
        "Interactive viewer: arrows step, Space plays/pauses, Q quits.",
    )
    plotter = pv.Plotter(window_size=window_size)
    plotter.background_color = "white"
    state = {"frame": 0, "playing": False, "slider": None}

    mesh["values"] = to_plot[0, :]
    plotter.add_mesh(
        mesh,
        scalars="values",
        cmap=cmap,
        clim=[0.0, CLIM_MAX],
        smooth_shading=True,
        show_edges=True,
        line_width=0.1,
        show_scalar_bar=False,
    )

    def hud_text():
        label = example_name or "transport"
        play = "playing" if state["playing"] else "paused"
        return f"{label}   t = {state['frame'] + 1}/{n_time}   [{play}]"

    def refresh():
        mesh["values"] = to_plot[state["frame"], :]
        plotter.add_text(
            hud_text(), font_size=13, position="upper_left", name="hud"
        )
        if state["slider"] is not None:
            state["slider"].GetRepresentation().SetValue(state["frame"] + 1)
        plotter.render()

    def goto(idx, wrap=False):
        if wrap:
            idx %= n_time
        state["frame"] = int(np.clip(idx, 0, n_time - 1))
        refresh()

    def toggle_play():
        state["playing"] = not state["playing"]
        refresh()

    plotter.add_key_event("Right", lambda: goto(state["frame"] + 1, wrap=True))
    plotter.add_key_event("Left", lambda: goto(state["frame"] - 1, wrap=True))
    plotter.add_key_event("Home", lambda: goto(0))
    plotter.add_key_event("End", lambda: goto(n_time - 1))
    plotter.add_key_event("space", toggle_play)

    state["slider"] = plotter.add_slider_widget(
        lambda value: goto(int(round(value)) - 1),
        [1, n_time],
        value=1,
        title=f"time step (1..{n_time})",
        pointa=(0.05, 0.08),
        pointb=(0.95, 0.08),
        fmt="%.0f",
        interaction_event="always",
    )
    plotter.add_text(
        "arrows: step   space: play/pause   home/end: jump   q: quit",
        position="lower_right",
        font_size=10,
        color="black",
        name="help",
    )

    def advance_if_playing(*_args):
        if state["playing"]:
            goto(state["frame"] + 1, wrap=True)

    try:  # autoplay ticker (pyvista >= 0.38); viewer works without it
        plotter.add_timer_event(
            max_steps=1 << 30, duration=120, callback=advance_if_playing
        )
    except Exception:  # pragma: no cover
        pass

    refresh()
    set_camera_with_config(plotter, camera_config)
    try:
        plotter.show()
    except Exception as exc:  # pragma: no cover
        logging.error(f"Error during plotter.show(): {exc}")
