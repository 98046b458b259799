"""Serving for the PyTorch port (the LLM inference engine in serve.llm)."""
