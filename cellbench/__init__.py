"""The serving benchmark of the PyTorch/CUDA port (`repro_torch`).

One command runs one cell once::

    python3 cellbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of ``workloads`` in ``BENCHMARK.json``: a configuration
(``cellbench/configs/<config>.json``) under a traffic mix
(``cellbench/traffic/<mix>.json``).  The harness finds everything by name:
the mix's loop kind in ``cellbench/loops/<loop>.py``; the configuration's
frame source in ``cellbench/sources/<frames>.py`` and its system under test
in ``cellbench/systems/<system>.py``, which compares the program's answers
with a plain reference of ``cellbench/reference/``; each metric's reader in
``cellbench/metrics/<metric>.py``.  A cell, configuration, system, mix or
metric is added as new files and entries; no existing file changes.

The harness owns the yardstick: the traffic, the float weights and frames
made from the seed, the operation and byte counts (`yardstick`), the
reduction of the profiler's trace (`trace`), the plain reference
(`reference`) and the comparison that decides ``correct`` (`check`, and
each system's ``compare``).  From the program it takes only the system under
test — for ``stream_pool``, ``repro_torch``'s `ContinuousBatcher` over a
captured `SessionPool` — and its tracer spans and kernel names.  Nothing
here imports JAX or the JAX package ``repro``.
"""
