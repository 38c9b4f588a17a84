"""Host-side building blocks of the reference's e2 module (own copies)."""
