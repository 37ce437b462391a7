"""Shared helpers of the port's benchmarks (the counterpart of the JAX
package's ``benchmarks/common.py``).

Every benchmark prints a table and writes its JSON under ``build/figures/``
(git-ignored; the JAX package's figure JSONs under ``experiments/figures/``
are its own and are never written here).  The engine benchmarks serve the
port's ``NeoEngine`` at full width on the card unless asked otherwise
(``--smoke``, ``--device cpu``), with weights drawn from a seeded
``torch.Generator``; the paper figures run the port's simulator on the host.
"""

from __future__ import annotations

import json
import os
import subprocess
from typing import Any, Dict, List, Mapping, Optional

import torch

import repro_torch.configs.paper_models  # noqa: F401  (registers the llama models)
from repro_torch.config import ArchConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.api import get_model

HERE = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
BUILD_DIR = os.path.join(REPO_ROOT, "build")
FIG_DIR = os.path.join(BUILD_DIR, "figures")


def save_json(name: str, data) -> str:
    os.makedirs(FIG_DIR, exist_ok=True)
    path = os.path.join(FIG_DIR, name)
    with open(path, "w") as f:
        json.dump(data, f, indent=1)
    return path


def card_line() -> Optional[str]:
    """The card's name and power limit as nvidia-smi gives them, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else None


def print_table(headers: List[str], rows: List[List]) -> None:
    w = [max(len(str(h)), max((len(str(r[i])) for r in rows), default=0))
         for i, h in enumerate(headers)]
    print(" | ".join(str(h).ljust(w[i]) for i, h in enumerate(headers)))
    print("-+-".join("-" * x for x in w))
    for r in rows:
        print(" | ".join(str(c).ljust(w[i]) for i, c in enumerate(r)))


# The paper's three Fig. 6 settings.
FIG6_SETTINGS = [
    # (label, hw, arch, trace, tp, rates)
    ("T4+LLaMa-2-7B+OSC", "t4_g4dn", "llama2-7b", "osc", 1,
     (0.25, 0.5, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 8.0)),
    ("A10G+LLaMa-3.1-8B+AC", "a10g_g5_4x", "llama31-8b", "ac", 1,
     (0.4, 0.8, 1.2, 1.6, 2.0, 2.4, 2.8, 3.2, 4.0, 4.8)),
    ("2xH100+LLaMa-3.1-70B+AC", "h100_sxm", "llama31-70b", "ac", 2,
     (0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0, 5.0, 6.0)),
]


def bench_config(arch: str = "qwen3-0.6b", *, smoke: bool = False,
                 dtype: Optional[str] = None, layers: Optional[int] = None) -> ArchConfig:
    """The model an engine benchmark serves: ``arch`` at full width (its
    smoke config under ``smoke``), in ``dtype`` and at ``layers`` layers
    (a cut of depth, not of width) when given."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if dtype is not None:
        cfg = cfg.replace(param_dtype=dtype, activation_dtype=dtype)
    if layers is not None:
        cfg = cfg.replace(num_layers=int(layers))
    return cfg


_PARAMS: Dict[Any, Dict[str, torch.Tensor]] = {}


def seeded_params(cfg: ArchConfig, seed: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """The port's random weights for ``cfg`` from a ``torch.Generator``
    seeded ``seed`` on ``device`` (the engine's own init), drawn once per
    (config, seed, device) and reused by the runs of a section; only the
    last set is kept."""
    key = (cfg, int(seed), str(device))
    if key not in _PARAMS:
        _PARAMS.clear()
        model = get_model(cfg, device=device)
        model.init(torch.Generator(device=device).manual_seed(int(seed)))
        _PARAMS[key] = {k: v.detach() for k, v in model.state_dict().items()}
        del model
    return _PARAMS[key]


def free_params() -> None:
    """Drop the cached weights (between sections on the card)."""
    _PARAMS.clear()


def engine_inputs(arch: str = "qwen3-0.6b", *, smoke: bool = False,
                  dtype: Optional[str] = None, layers: Optional[int] = None, device=None,
                  params: Optional[Mapping[str, Any]] = None, seed: int = 0):
    """(config, device, weights) of one engine run: ``params`` when given
    (the tests pass the JAX package's, through the bridge), else the seeded
    weights of :func:`seeded_params`.  ``device`` goes through
    ``resolve_device``: the card unless ``"cpu"`` is asked for."""
    cfg = bench_config(arch, smoke=smoke, dtype=dtype, layers=layers)
    dev = resolve_device(device)
    if params is None:
        params = seeded_params(cfg, seed, dev)
    return cfg, dev, params


def engine_overrides(ewma_alpha: Optional[float],
                     host_threads: Optional[int] = None) -> Dict[str, Any]:
    """EngineConfig fields a benchmark run overrides: ``ewma_alpha`` (0
    freezes the perf model, so the plans follow the inputs alone) and
    ``host_threads`` (the host attention's worker threads; rows stay
    independent, so no token moves)."""
    out: Dict[str, Any] = {}
    if ewma_alpha is not None:
        out["ewma_alpha"] = float(ewma_alpha)
    if host_threads is not None:
        out["host_threads"] = int(host_threads)
    return out


def add_engine_args(ap) -> None:
    """The flags every engine benchmark adds to the JAX package's."""
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config (default: full width)")
    ap.add_argument("--dtype", default=None, choices=("float32", "bfloat16"),
                    help="override the config's parameter and activation dtype")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the model's depth (default: the config's)")
    ap.add_argument("--device", default=None,
                    help="cuda (default: the card) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ewma-alpha", type=float, default=None,
                    help="the perf model's EWMA weight (0 freezes it)")


def engine_opts(args) -> Dict[str, Any]:
    """The keyword options of the engine benchmarks' run functions, from
    the flags of :func:`add_engine_args`."""
    return dict(arch=args.arch, smoke=args.smoke, dtype=args.dtype, layers=args.layers,
                device=args.device, seed=args.seed, ewma_alpha=args.ewma_alpha)
