"""Training: AdamW and its schedules, the train, prefill and decode steps,
and checkpoints of ``params`` or ``(params, opt_state)``."""
