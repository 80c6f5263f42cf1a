"""Command-line entry point: ``python -m tclb_tpu_torch``.

``run case.xml`` runs an XML case on the card (``--device cpu`` runs it on
the host with the eager engine); ``models`` lists the ported catalogue and
``describe`` dumps a model's registry.  The ``sweep`` and ``gateway``
subcommands of the JAX package wait for ROADMAP queue 1 items 14 and 15.
"""

from __future__ import annotations

import argparse
import json
import sys


def _cmd_run(args) -> int:
    import xml.etree.ElementTree as ET

    import torch

    from tclb_tpu_torch.control.solver import run_config
    from tclb_tpu_torch.models import get_model

    model_name = args.model or ET.parse(args.case).getroot().get("model")
    if model_name is None:
        print("error: no --model flag and no model= attribute on "
              "<CLBConfig>", file=sys.stderr)
        return 2
    dtype = {"f32": torch.float32, "f64": torch.float64}[args.precision]
    solver = run_config(args.case, get_model(model_name), dtype=dtype,
                        output=args.output, device=args.device)
    solver.lattice.synchronize()
    print(f"done: {solver.iter} iterations on {solver.lattice.device} "
          f"(engine {solver.lattice.engine_name})")
    return 0


def _cmd_models(args) -> int:
    from tclb_tpu_torch.models import get_model, list_models
    for name in list_models():
        if args.verbose:
            m = get_model(name)
            print(f"{name:32s} {m.ndim}D  {m.description}")
        else:
            print(name)
    return 0


def _cmd_describe(args) -> int:
    """Model introspection as JSON."""
    from tclb_tpu_torch.models import get_model
    m = get_model(args.model)
    info = {
        "name": m.name,
        "ndim": m.ndim,
        "description": m.description,
        "densities": list(m.storage_names),
        "settings": [{"name": s.name, "default": s.default,
                      "zonal": s.zonal, "comment": s.comment}
                     for s in m.settings],
        "quantities": sorted(m.quantity_fns),
        "globals": [g.name for g in m.globals_],
        "node_types": sorted(m.node_types),
        "stages": sorted(m.stages),
        "actions": {k: list(v) for k, v in m.actions.items()},
    }
    print(json.dumps(info, indent=2, default=str))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tclb_tpu_torch",
        description="lattice-Boltzmann framework on PyTorch and CUDA")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="run an XML case file")
    r.add_argument("case", help="case.xml config")
    r.add_argument("--model", "-m", help="model name (or model= attr in "
                   "the config)")
    r.add_argument("--output", "-o", default=None, help="output prefix")
    r.add_argument("--precision", choices=("f32", "f64"), default="f32")
    r.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where the lattice lives (default: the card)")
    r.set_defaults(fn=_cmd_run)

    ls = sub.add_parser("models", help="list the model catalogue")
    ls.add_argument("--verbose", "-v", action="store_true")
    ls.set_defaults(fn=_cmd_models)

    d = sub.add_parser("describe", help="dump a model's registry as JSON")
    d.add_argument("model")
    d.set_defaults(fn=_cmd_describe)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
