"""``python -m repro_torch.analysis`` entry point."""
from .cli import main

raise SystemExit(main())
