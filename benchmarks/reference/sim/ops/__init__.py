"""Plain ops of the sim step and renderer."""
