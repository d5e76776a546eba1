"""Flow-Attention math shared by every execution strategy."""
