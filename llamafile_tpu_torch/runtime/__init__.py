"""Runtime of the port: KV cache, sampling, tokenizer, engine."""
