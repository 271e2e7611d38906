"""Model families of the port (imports nothing eagerly)."""
