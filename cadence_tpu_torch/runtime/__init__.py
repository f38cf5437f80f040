"""Runtime services the rebuild path needs: the history store and the
state rebuilder."""
