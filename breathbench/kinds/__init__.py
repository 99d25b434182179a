"""The general generators, one per traffic kind; a traffic file's "kind"
names one, and its other keys are that generator's parameters."""
