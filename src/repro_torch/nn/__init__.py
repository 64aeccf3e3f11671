"""Neural-network building blocks of the port (``repro/nn``): parameter
specs and init (``param``), layers, rotary embeddings and attention."""
