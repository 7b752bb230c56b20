"""Plain references the checks compare with."""
