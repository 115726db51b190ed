"""Model runtimes of the port (llama / mistral)."""
