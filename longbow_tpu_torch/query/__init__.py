"""Query parsing and filtering."""
