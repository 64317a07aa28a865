"""The benchmark of ``dint_tpu_torch`` on one NVIDIA card.

One command runs one cell once (``python3 -m benchmark.run``).  The
cells, configurations, traffic mixes and metrics are named in
``BENCHMARK.json`` at the checkout's root; each configuration, traffic
mix and per-layer metric lives in a file of its own under this folder
and is found by its name.  Nothing here imports ``jax`` or the JAX
package ``dint_tpu``; the plain reference (``reference.py``) imports
nothing of ``dint_tpu_torch`` either.
"""
