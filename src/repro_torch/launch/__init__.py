"""Launch layer of the port: the LM serving driver (``serve.py``)."""
