"""Launch layer of the port: the LM and simulation serving launcher
(``serve.py``), the LM training launcher (``train.py``), and the dry run
of the zoo and the paper's round on the ``meta`` device (``dryrun.py``,
over the device-free meshes of ``mesh.py`` and the collective reckoning
of ``comm_analysis.py``)."""
