"""``python -m repro_torch.daemon`` — run the optimizer daemon (see
``server.main``)."""
from .server import main

if __name__ == "__main__":
    raise SystemExit(main())
