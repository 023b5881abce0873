"""Entry points: ``serve`` (batched prefill-by-decode serving)."""
