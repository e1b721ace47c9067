"""Model configurations, copied value for value from the reference's."""
