"""The port's roofline (port of ``repro/roofline``): the H100's rates
(:mod:`.analysis`), each kernel's work from its shapes (:mod:`.work`), a
counter of a step's work (:mod:`.counter`), and the sweep and tables
(:mod:`.run_all`, :mod:`.report`) over the dry run's records
(``repro_torch.launch.dryrun``).

Nothing here imports a kernel module: the kernel wrappers import
:mod:`.work` and :mod:`.counter`.
"""
