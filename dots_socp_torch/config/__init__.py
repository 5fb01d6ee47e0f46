# The port's own copy of dots_socp_tpu/config/__init__.py; relative paths are
# normalised, because the port's path_config.toml points at the data files
# where they lie (../dots_socp_tpu/data).
"""Configuration layer: paths + logging levels loaded from TOML.

Parity with reference `dot_surface_socp/config/__init__.py:1-58` (same exported
constants `PATHS`, `LOG_LEVELS`, same custom log levels kkt=11 / scaling=12).
"""

import logging
import os

try:  # Python >= 3.11
    import tomllib as _toml
except ImportError:  # pragma: no cover
    import tomli as _toml  # type: ignore

_CONFIG_DIR = os.path.dirname(os.path.abspath(__file__))


def _load(path):
    with open(path, "rb") as f:
        return _toml.load(f)


_paths_cfg = _load(os.path.join(_CONFIG_DIR, "path_config.toml"))
if "paths" not in _paths_cfg:
    raise ValueError("path_config.toml must define a [paths] table")

#: Directories holding mesh files, example settings, and camera configs,
#: relative to the package root unless absolute.
_PKG_ROOT = os.path.dirname(_CONFIG_DIR)
PATHS = {
    key: val if os.path.isabs(val) else os.path.normpath(os.path.join(_PKG_ROOT, val))
    for key, val in _paths_cfg["paths"].items()
}

_log_cfg = _load(os.path.join(_CONFIG_DIR, "logging_config.toml"))
if "log_levels" not in _log_cfg:
    raise ValueError("logging_config.toml must define a [log_levels] table")

_levels = _log_cfg["log_levels"]
for _required in ("debug", "info", "kkt", "scaling"):
    if _required not in _levels:
        raise ValueError(f"missing log level: {_required}")

#: Logging levels, including the custom 'kkt' and 'scaling' levels sitting
#: between DEBUG and INFO so that KKT traces can be enabled independently.
LOG_LEVELS = {k: _levels[k] for k in ("debug", "info", "kkt", "scaling")}

logging.addLevelName(LOG_LEVELS["kkt"], "KKT")
logging.addLevelName(LOG_LEVELS["scaling"], "SCALING")
