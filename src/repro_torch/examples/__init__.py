"""The reference's four examples on the port (port of ``examples/``), each
a module with ``main(argv)``:

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

``quickstart``, ``composability``, ``serve_longcontext`` and
``train_gate``. Each runs on ``cuda`` unless ``--device cpu`` asks for the
host; nothing runs on import.
"""
