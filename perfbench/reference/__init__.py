"""The plain float32 reference the system is held to. Imports nothing of
the system under test."""
