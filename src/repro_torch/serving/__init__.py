"""Serving of the port: host Scheduler, device Worker, Engine facade."""
