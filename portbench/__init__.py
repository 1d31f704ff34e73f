"""The benchmark of ``infiniteexamodels_jl_torch`` on the card.

    python3 -m portbench.run --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the checkout's root lists the cells; each
configuration (``configs/``), traffic mix (``traffic/``) and metric
(``metrics/``) is a file found by its name.  ``reference/`` holds the
plain reference that decides ``correct``.
"""
