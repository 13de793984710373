"""The benchmark of ``raytracercore_tpu_torch``, the PyTorch and CUDA port.

One command runs one cell once, from the root of a checkout::

    python3 -m rtbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cells, metrics and bounds are listed in ``BENCHMARK.json``.  What
belongs to one configuration, traffic mix, loop or per-layer metric sits
in a file of its own that the harness finds by name:
``configs/<config>.json``, ``traffic/<mix>.json``, ``loops/<loop>.py``,
``metrics/<metric>.py``.  ``reference/`` holds the plain reference the
outputs are held to.  Nothing here imports JAX or the JAX package.
"""
