"""Model catalogue of the PyTorch port.  ``get_model`` builds (and caches)
the frozen Model with physics bound.  The catalogue is the JAX package's,
all 42 models: ``d2q9`` and its family (``d2q9_SRT``, ``d2q9_les``,
``d2q9_inc``, ``d2q9_cumulant``, ``d2q9_new``), the z-slab family
(``d3q27_cumulant``, ``d3q27_BGK``, ``d3q27_BGK_galcor``, ``d3q19``,
``d3q19_les``), ``d2q9_kuper``, the one-stage 2D models (``d2q9_heat``,
``d2q9_heat_conjugate``, ``d2q9_hb``, ``sw``, ``d2q9_solid``,
``d2q9_npe_guo``), the multi-stage 2D models
(``d2q9_pf_pressureEvolution``, ``d2q9_pp_MCMP``, ``d2q9_lee``,
``d2q9_poison_boltzmann``), the adjoint models ``d2q9_heat_adj``,
``d2q9_adj``, ``d2q9_optimalMixing``, ``d2q9_plate``, ``d3q19_adj``,
``d2q9_kuper_adj`` and the 3D heat design family (``d3q19_heat_adj``,
``d3q19_heat_adj_art``, ``d3q19_heat_adj_prop``), the 3D models of the
generic engine (``d3q19_heat``, ``d3q27``, ``d3q27_viscoplastic``,
``d3q27_cumulant_qibb_small``, ``d3q19_kuper``), and the models of the
phase-field, pseudopotential and design workflows (``wave``, ``wave2d``,
``d2q9_diff``, ``d2q9_pf``, ``d2q9_pp_LBL``, ``d2q9_pf_curvature``)."""

from __future__ import annotations

import importlib

from tclb_tpu_torch.core.registry import Model

# model name -> module path ("module.path" uses its build(),
# "module.path:fn" its fn())
_REGISTRY: dict[str, str] = {
    "d2q9": "tclb_tpu_torch.models.d2q9",
    "d2q9_SRT": "tclb_tpu_torch.models.d2q9_srt",
    "d2q9_les": "tclb_tpu_torch.models.d2q9_les",
    "d2q9_inc": "tclb_tpu_torch.models.d2q9_inc",
    "d2q9_cumulant": "tclb_tpu_torch.models.d2q9_cumulant",
    "d2q9_new": "tclb_tpu_torch.models.d2q9_new",
    "d3q27_cumulant": "tclb_tpu_torch.models.d3q27_cumulant",
    "d3q27_BGK": "tclb_tpu_torch.models.d3q27_bgk",
    "d3q27_BGK_galcor": "tclb_tpu_torch.models.d3q27_bgk:build_galcor",
    "d2q9_kuper": "tclb_tpu_torch.models.d2q9_kuper",
    "d2q9_heat": "tclb_tpu_torch.models.d2q9_heat",
    "d2q9_heat_conjugate": "tclb_tpu_torch.models.d2q9_heat_conjugate",
    "d2q9_hb": "tclb_tpu_torch.models.d2q9_hb",
    "d2q9_heat_adj": "tclb_tpu_torch.models.d2q9_heat_adj",
    "d2q9_adj": "tclb_tpu_torch.models.d2q9_adj",
    "d2q9_optimalMixing": "tclb_tpu_torch.models.d2q9_optimal_mixing",
    "d2q9_plate": "tclb_tpu_torch.models.d2q9_plate",
    "sw": "tclb_tpu_torch.models.sw",
    "d2q9_solid": "tclb_tpu_torch.models.d2q9_solid",
    "d2q9_npe_guo": "tclb_tpu_torch.models.d2q9_npe_guo",
    "d2q9_pf_pressureEvolution":
        "tclb_tpu_torch.models.d2q9_pf_pressure_evolution",
    "d2q9_pp_MCMP": "tclb_tpu_torch.models.d2q9_pp_mcmp",
    "d2q9_lee": "tclb_tpu_torch.models.d2q9_lee",
    "d2q9_poison_boltzmann": "tclb_tpu_torch.models.d2q9_poison_boltzmann",
    "wave": "tclb_tpu_torch.models.wave",
    "wave2d": "tclb_tpu_torch.models.wave2d",
    "d2q9_diff": "tclb_tpu_torch.models.d2q9_diff",
    "d2q9_pf": "tclb_tpu_torch.models.d2q9_pf",
    "d2q9_pp_LBL": "tclb_tpu_torch.models.d2q9_pp_lbl",
    "d2q9_pf_curvature": "tclb_tpu_torch.models.d2q9_pf_curvature",
    "d3q19": "tclb_tpu_torch.models.d3q19",
    "d3q19_les": "tclb_tpu_torch.models.d3q19_les",
    "d3q19_adj": "tclb_tpu_torch.models.d3q19_adj",
    "d3q19_heat": "tclb_tpu_torch.models.d3q19_heat",
    "d3q27": "tclb_tpu_torch.models.d3q27",
    "d3q27_viscoplastic": "tclb_tpu_torch.models.d3q27_viscoplastic",
    "d3q27_cumulant_qibb_small": "tclb_tpu_torch.models.d3q27_cumulant_qibb",
    "d3q19_kuper": "tclb_tpu_torch.models.d3q19_kuper",
    "d3q19_heat_adj": "tclb_tpu_torch.models.d3q19_heat_adj",
    "d3q19_heat_adj_art": "tclb_tpu_torch.models.d3q19_heat_adj:build_art",
    "d3q19_heat_adj_prop":
        "tclb_tpu_torch.models.d3q19_heat_adj:build_prop",
    "d2q9_kuper_adj": "tclb_tpu_torch.models.d2q9_kuper_adj",
}

_CACHE: dict[str, Model] = {}


def list_models() -> list[str]:
    return sorted(_REGISTRY)


def get_model(name: str) -> Model:
    if name not in _CACHE:
        if name not in _REGISTRY:
            raise KeyError(f"model {name!r} is not in the catalogue; "
                           f"models: {list_models()}")
        path, _, fn = _REGISTRY[name].partition(":")
        _CACHE[name] = getattr(importlib.import_module(path), fn or "build")()
    return _CACHE[name]
