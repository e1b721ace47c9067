"""The benchmark of the PyTorch and CUDA port of IRLI (``repro_torch``).

One command runs one cell once::

    python irli_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: ``workloads/<cell>.json`` names
its configuration (``configs/<config>.json``) and its traffic mix
(``traffic/<traffic>.json``), whose ``generator`` is ``traffic/<generator>.py``;
each end-to-end metric is read by ``e2e/<metric>.py`` and each per-layer
metric by ``layers/<metric>.py`` (a ``<quantity>.<cells>`` name with no
file of its own by ``<quantity>.py``), and each kernel's work is counted
by ``cost/<kernel>.py``. The plain reference that decides
``correct`` is ``reference/``. Nothing here imports JAX or the JAX package.
"""
