"""Checkpoints, training logs and mel figures of the port (`checkpoint`,
`logging`, `plotting`).

Nothing is imported here, so that importing one of them pulls in no other.
"""
