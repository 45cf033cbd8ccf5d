"""LM architecture zoo of the port: the dense GQA transformer and its VLM
backbone (``transformer.py``) behind the unified serving API of
``lm.py``.  MoE, RWKV6, Mamba2 hybrid and whisper are not ported yet."""
