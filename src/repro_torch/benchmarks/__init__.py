"""The paper's figure benchmarks and the serving A/B on the port (port of
``benchmarks/``): one module per figure, each with ``run(device=None)``
returning ``(name, us_per_call, derived)`` rows, and :mod:`.run`, which
prints them as CSV.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--only fig8] \\
        [--device cpu]

Every draw comes from a seeded ``torch.Generator`` (numpy for the serving
trace), so the port's numbers are its own, not the reference's figures;
each helper that draws also takes the batch, so a test can hand both
packages the same tokens. Nothing runs on import.
"""
