"""The training plane: AdamW (``optimizer``), the synthetic token pipeline
(``data``) and the checkpoint manager (``checkpoint``), each the port of
the reference module of the same name."""
