"""The benchmark of the PyTorch/CUDA port (``clip_assisted_data_labeling_tpu_torch``).

One command runs one cell once, from the root of a checkout::

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root lists the configurations, cells and metrics.
Everything that belongs to one of them sits in a file of its own, found by
name: ``configs/<config>.json`` (a tower's published sizes), ``traffic/<mix>.json``
(the parameters of a mix, read by the generator in ``drivers/<driver>.py`` that
the file names), ``metrics/<metric>.py`` (a reader of one metric) and
``limits/<cell>.json`` (the limits of the numbers that decide ``correct``).
``reference/`` holds the plain float32 versions the outputs are judged against;
it imports nothing of the port.
"""
