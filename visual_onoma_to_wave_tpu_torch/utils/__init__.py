"""Checkpoints and training logs of the port (`checkpoint`, `logging`).

Nothing is imported here, so that importing one of them pulls in no other.
"""
