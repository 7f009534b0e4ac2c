"""The plain reference: frozen coefficient quadrature and a float32 model."""
