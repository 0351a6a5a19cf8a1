"""Plain references of what the program under test computes."""
