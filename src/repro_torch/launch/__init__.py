"""Entry points: ``serve`` (batched prefill-by-decode serving), ``train``
(the trainer with checkpoint/restart) and ``mesh`` (its meshes)."""
