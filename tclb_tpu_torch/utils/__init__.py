"""Host-side utilities: units, geometry, output writers, logging."""
