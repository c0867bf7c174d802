"""The model pool and the forward-only serving step."""
