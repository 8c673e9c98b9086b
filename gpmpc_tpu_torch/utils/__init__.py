"""Controller checkpointing (``checkpoint``) and planning-step timing
(``profiling``)."""
