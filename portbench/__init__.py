"""portbench — the benchmark of ``dla_tpu_torch``, the PyTorch/CUDA port.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The harness is driven by data. A cell names a configuration
(``configs/<config>.json``: the deployment's sizes, its entry into the
program and that entry's keyword arguments, its check's limits and its
control) and a traffic mix (``traffic/<mix>.json``: parameters that
:mod:`portbench.window` reads, and the entry it drives where that is not the
configuration's). An entry is a module of its own (``entries/<entry>.py``:
the system the window drives and the numbers its check compares), a metric
is a reader of its own (``metrics/<metric>.py``), and the kernels of a layer
are named by the regular expressions of ``layers/<layer>/*.txt``. A later
change adds such files and edits none.

Only the entry modules import the program, and only through its public
functions. The plain reference (:mod:`portbench.reference`) imports neither
the program nor JAX.
"""
