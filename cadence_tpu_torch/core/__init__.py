"""Event, id and enum definitions, and the history event constructors."""
