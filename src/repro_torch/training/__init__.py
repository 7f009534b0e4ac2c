"""Training-side pieces the serving launcher needs: the prefill and decode
steps and checkpoints (the train step waits for the training slice)."""
