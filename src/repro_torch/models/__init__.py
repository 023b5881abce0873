"""The language-model families (``transformer``: dense, vlm and moe;
``ssm``: Mamba-2; ``griffin``: RecurrentGemma; ``encdec``: SeamlessM4T),
their shared ``layers``, and the registry ``api``."""
