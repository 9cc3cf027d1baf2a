"""Model configurations of the port. Only granite-8b so far; the other
nine of ``repro.configs`` wait for the dense-decoder slice."""
