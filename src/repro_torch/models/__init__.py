"""LM architecture zoo of the port: the dense GQA transformer and its VLM
backbone (``transformer.py``), MoE (``moe.py``), RWKV6 (``rwkv6.py``), the
Zamba2 hybrid (``zamba2.py``) and whisper (``whisper.py``), behind the
unified serving and training API of ``lm.py``."""
