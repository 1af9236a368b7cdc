"""Entry points of the port's model zoo: serving (``serve``), training
(``train``), and the multi-device planning tools: the production meshes
(``mesh``), each (arch × shape) cell's step and arguments (``specs``),
the fake-mesh dry run (``dryrun``, counting with ``comm_analysis``) and
its roofline under H100 constants (``roofline``, ``perf``)."""
