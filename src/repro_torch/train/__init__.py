"""Training for the port: the repo's own AdamW (``optimizer``), the
checkpointer (``checkpoint``) and the JAX-ordered tree walk both use
(``tree``). The online trainer is ``runtime.trainer``."""
