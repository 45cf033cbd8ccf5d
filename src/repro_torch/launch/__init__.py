"""Launch layer of the port: the LM and simulation serving launcher
(``serve.py``) and the LM training launcher (``train.py``)."""
