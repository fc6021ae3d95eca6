"""Gate-distillation training of the port (port of ``repro/training``)."""
