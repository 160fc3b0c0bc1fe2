"""The yardstick's counting: nominal FLOPs in direct form and the bytes a
stage or kernel must move at least, and the card's published peaks."""
