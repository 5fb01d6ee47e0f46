"""The one generator of the benchmark's traffic: problems from a mix's
parameters (`otbench/traffic/<mix>.json`) and the run's seed.

A mix names a problem `family` and its parameters; the family decides how
one problem's inputs are drawn. Every draw comes from NumPy's generator on
(seed, stream): stream 0 gives the measured window's problems in order,
stream 1 the warm-up's, so the same seed gives the same problems.

Families:

  gauss_pair -- the plane example's pair of isotropic gaussians
                (`reference.plane.gaussian_mass`) with the mix's `scale`,
                the second centre `displacement` away from the first; the
                first centre and the direction are drawn so that both
                centres lie in the square `box` (z = 0).
"""

from __future__ import annotations

import math

import numpy as np

from otbench.reference import plane

WINDOW, WARMUP = 0, 1


def rng(seed: int, stream: int) -> np.random.Generator:
    # Any whole number is a seed: it is taken modulo 2**64.
    return np.random.default_rng([int(seed) % 2**64, stream])


def _gauss_pair(mix: dict, geom: dict, gen: np.random.Generator) -> dict:
    lo, hi = mix["box"]
    dist = float(mix["displacement"])
    while True:
        start = gen.uniform(lo, hi, size=2)
        angle = gen.uniform(0.0, 2.0 * math.pi)
        end = start + dist * np.array([math.cos(angle), math.sin(angle)])
        if np.all((end >= lo) & (end <= hi)):
            break
    c0, c1 = np.append(start, 0.0), np.append(end, 0.0)
    return {"mu0": plane.gaussian_mass(geom, c0, mix["scale"]),
            "mu1": plane.gaussian_mass(geom, c1, mix["scale"]),
            "centers": [c0.tolist(), c1.tolist()]}


FAMILIES = {"gauss_pair": _gauss_pair}


def problems(mix: dict, geom: dict, seed: int, stream: int = WINDOW):
    """Endless iterator of the mix's problems: dicts with the boundary
    masses `mu0`, `mu1` and what was drawn."""
    draw = FAMILIES[mix["family"]]
    gen = rng(seed, stream)
    while True:
        yield draw(mix, geom, gen)
