"""Training: schedules, AdamW and Adafactor, and the train step
(``train_state.py``)."""
