"""Plain references, one a configuration's ``reference`` name."""
