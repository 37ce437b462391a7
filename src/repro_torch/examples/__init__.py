"""The JAX package's examples (``examples/``) on the port, each a module run
as ``python -m repro_torch.examples.<name>`` with ``main(argv=None)``:

* :mod:`.quickstart` — NEO against GPU-only on a tiny device pool, tokens
  asserted equal;
* :mod:`.serve_online` — Poisson OSC arrivals through ``engine.step(now=...)``,
  with ``--crash`` journal recovery;
* :mod:`.capacity_planner` — the calibrated simulator's sustainable load,
  NEO against GPU-only;
* :mod:`.train_mini` — a ~100M-parameter qwen3-family model trained for a
  few hundred steps with a mid-run restart from its checkpoint.

Each runs on the card unless given ``--device cpu`` (without a card it
raises).  The engine examples serve the reference's smoke config by
default, so a CPU run is comparable with the reference's; ``--full`` serves
the full-width model, with random weights from a seeded
``torch.Generator`` unless ``params=`` (a state dict, e.g. the JAX
package's weights through ``models/bridge.py``) is passed.
"""
