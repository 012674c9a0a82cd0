"""Host-side applications: the synthetic star-field sequence renderer."""
