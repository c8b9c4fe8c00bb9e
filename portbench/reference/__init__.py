"""Plain fp32 references: they import neither JAX nor the port."""
