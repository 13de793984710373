"""Tools that are run by hand on the card, never by a benchmark run."""
