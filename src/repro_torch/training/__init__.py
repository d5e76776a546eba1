"""Training: schedules, AdamW and the train step (``train_state.py``)."""
