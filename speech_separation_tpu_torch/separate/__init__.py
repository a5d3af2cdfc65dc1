"""Wave-to-wave separation."""
