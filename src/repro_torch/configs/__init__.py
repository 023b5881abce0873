"""Architecture configs: ``base.ArchConfig`` and one module per arch
exporting ``CONFIG`` (the reference's ten, field for field)."""
