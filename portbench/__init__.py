"""The benchmark of the PyTorch/CUDA port ``uncertainty_model_tpu_torch``.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card it is
started on (``harness.py`` says how each piece is found by name);
``python3 -m portbench.control`` reads the numbers a cell's limits are set
from; ``python -m pytest portbench/tests`` runs the benchmark's CPU tests
(the card's test is marked ``gpu``).  Nothing here imports JAX or the JAX
package.
"""
